"""PyTorch port, fused tier on the CPU: ``fused_solve`` (its plain version)
vs the JAX package's ``fused_solve(..., interpret=True)`` as tests/test_fused.py
runs it, and vs the port's own scan tier in float64.

Bars: U/X/carries atol 1e-4 (the JAX tests' own interpret-mode bar between
float32 tiers); adaptive iteration counts agree on >= 90 % of instances
(float32 sums ordered differently shift a check that sits on the tolerance,
as tests/test_rollout_kernel.py allows); in float64 against the scan tier
counts are exactly equal and values agree to 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.models import (
    quadrotor_hovering_setup as hovering_j,
    random_lti_problem as random_lti_j,
)
from accelerated_tinympc_tpu.ops import fused_admm as fj
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
    riccati_cache as riccati_cache_j,
)
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft
from accelerated_tinympc_tpu_torch.solver import (
    init_state_batched, solve_batched,
)

from torch_parity_utils import (
    DEV, assert_fused_close, cache_to_torch, jax_fused_result_fields,
    perturbed_x0, problem_to_torch, to_np, torch_pp,
)

ATOL = 1e-4
B = 8


def _setup(pj, cj, x0, batch, seed, spread=0.1):
    ops_j = condensed_operators_j(cj, np.asarray(pj.A), np.asarray(pj.B),
                                  pj.horizon)
    ppj = fj.pad_problem(pj, cj, ops_j)
    pt, ct = problem_to_torch(pj), cache_to_torch(cj)
    _, ppt = torch_pp(pt, ct)
    x0s = perturbed_x0(x0, batch, seed, spread).astype(np.float32)
    return ppj, ppt, pt, ct, x0s


@pytest.fixture(scope="module")
def quad():
    pj, cj, x0 = hovering_j()
    return (pj, cj) + _setup(pj, cj, x0, B, seed=7)


def _both(ppj, ppt, x0s, carry_j=None, carry_t=None, **kw):
    n = x0s.shape[0]
    carry_j = carry_j or fj.FusedCarry.zeros(n, ppj)
    carry_t = carry_t or ft.FusedCarry.zeros(n, ppt, device=DEV)
    jkw = dict(kw)
    for k in ("xref_q", "pterm_c"):
        if k in jkw:
            jkw[k] = jkw.pop(k)[0]
            kw[k] = kw[k][1]
    want = fj.fused_solve(jnp.asarray(x0s), carry_j, ppj, batch_tile=n,
                          interpret=True, **jkw)
    got = ft.fused_solve(torch.as_tensor(x0s), carry_t, ppt, **kw)
    return got, want


def _stats_close(got, want, rows=slice(None)):
    g, w = to_np(got.stats), np.asarray(want.stats)[:, :6]
    np.testing.assert_array_equal(g[rows, :2], w[rows, :2])
    # residuals: rho * max|a - b| of iterates that agree to ATOL (rho = 5)
    np.testing.assert_allclose(g[rows, 2:], w[rows, 2:], rtol=1e-3, atol=1e-3)


def test_fixed_cold_matches_jax(quad):
    _pj, _cj, ppj, ppt, _pt, _ct, x0s = quad
    got, want = _both(ppj, ppt, x0s, max_iter=25, check_termination=0)
    assert_fused_close(got, want, ppt.dims, atol=ATOL)
    _stats_close(got, want)
    assert got.U.shape == (B, 36) and got.X.shape == (B, 120)
    assert got.stats.shape == (B, 6)


def test_fixed_warm_carry_matches_jax(quad):
    pj, _cj, ppj, ppt, pt, _ct, x0s = quad
    _, first = _both(ppj, ppt, x0s, max_iter=20, check_termination=0)
    carry_t = convert.fused_carry_from_numpy(
        jax_fused_result_fields(first)["carry"], ppt.dims, device=DEV)
    u0 = np.asarray(first.U[:, :4])
    x1 = x0s @ np.asarray(pj.A).T + u0 @ np.asarray(pj.B).T
    got, want = _both(ppj, ppt, x1, first.carry.reset_duals(),
                      carry_t.reset_duals(), max_iter=20, check_termination=0)
    assert_fused_close(got, want, ppt.dims, atol=ATOL)


ADAPTIVE = {
    "check1": dict(max_iter=150, check_termination=1),
    "check5_warmup": dict(max_iter=150, check_termination=5, warmup_iters=12),
    "alpha1.6": dict(max_iter=80, check_termination=1, alpha=1.6),
}


@pytest.mark.parametrize("case", list(ADAPTIVE))
def test_adaptive_matches_jax(quad, case):
    _pj, _cj, ppj, ppt, _pt, _ct, x0s = quad
    got, want = _both(ppj, ppt, x0s, abs_pri_tol=0.05, abs_dua_tol=0.05,
                      **ADAPTIVE[case])
    it_g, it_w = to_np(got.stats[:, 0]), np.asarray(want.stats[:, 0])
    same = it_g == it_w
    assert same.mean() >= 0.9, (it_g, it_w)
    assert len(set(it_g.tolist())) > 1  # the exits really diverge
    wt = convert.fused_result_from_numpy(
        jax_fused_result_fields(want), ppt.dims, device=DEV)
    for name, a, b in [("U", got.U, wt.U), ("X", got.X, wt.X)] + [
            (k, getattr(got.carry, k), getattr(wt.carry, k))
            for k in ("D", "Y", "G", "Z", "V")]:
        np.testing.assert_allclose(to_np(a)[same], to_np(b)[same],
                                   rtol=0, atol=ATOL, err_msg=name)
    _stats_close(got, want, same)


def test_tracking_ref_vectors_match_jax(quad):
    pj, cj, ppj, ppt, pt, ct, x0s = quad
    rng = np.random.default_rng(2)
    window = (0.3 * rng.standard_normal((10, 12))).astype(np.float32)
    xq_j, pc_j = fj.ref_vectors(ppj, pj.Q, cj.Pinf, jnp.asarray(window))
    xq_t, pc_t = ft.ref_vectors(ppt, pt.Q, ct.Pinf, torch.as_tensor(window))
    np.testing.assert_allclose(to_np(xq_t)[0], np.asarray(xq_j)[0, :120],
                               atol=1e-6)
    np.testing.assert_allclose(to_np(pc_t)[0], np.asarray(pc_j)[0, :120],
                               atol=1e-5)
    got, want = _both(ppj, ppt, x0s, max_iter=25, check_termination=0,
                      xref_q=(xq_j, xq_t), pterm_c=(pc_j, pc_t))
    assert_fused_close(got, want, ppt.dims, atol=ATOL)


def test_random_lti_unpacked_shape_and_ragged_batch():
    """nx=6, nu=8, N=12: Du=88, the TPU layout's unpacked g=1 case; batch 5
    is ragged for every tile."""
    pj, rho = random_lti_j(3, 6, 8, 12)
    cj = riccati_cache_j(np.asarray(pj.A), np.asarray(pj.B), np.asarray(pj.Q),
                         np.asarray(pj.R), rho)
    ppj, ppt, _pt, _ct, x0s = _setup(pj, cj, np.zeros(6), 5, seed=1, spread=1.0)
    assert ppj.g == 1 and ppt.dims == (6, 8, 12)
    got, want = _both(ppj, ppt, x0s, max_iter=30, check_termination=0)
    assert_fused_close(got, want, ppt.dims, atol=ATOL)
    got, want = _both(ppj, ppt, x0s, max_iter=60, check_termination=1)
    assert (to_np(got.stats[:, 0]) == np.asarray(want.stats[:, 0])).mean() >= 0.8
    same = to_np(got.stats[:, 0]) == np.asarray(want.stats[:, 0])
    np.testing.assert_allclose(to_np(got.U)[same],
                               np.asarray(want.U)[same, :88], atol=ATOL)


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "adaptive_check4"])
def test_fused_equals_scan_tier_f64(mode):
    """The folded iteration is the scan tier's schedule exactly: in float64
    counts are equal and values agree to rounding."""
    tdt = torch.float64
    p, c, x0 = atm_t.models.quadrotor_hovering_setup(dtype=tdt, device=DEV)
    kw = {"fixed": dict(max_iter=40, check_termination=0),
          "adaptive": dict(max_iter=150, check_termination=1),
          "adaptive_check4": dict(max_iter=150, check_termination=4)}[mode]
    tol = dict(abs_pri_tol=0.05, abs_dua_tol=0.05)
    x0s = perturbed_x0(x0, 6, seed=8)
    st = atm_t.set_x0(init_state_batched(6, 12, 4, 10, tdt, DEV), x0s)
    want = solve_batched(st, p, c, atm_t.Settings(**kw, **tol))
    _, pp = torch_pp(p, c, tdt)
    got = ft.fused_solve(torch.as_tensor(x0s), ft.FusedCarry.zeros(6, pp, tdt, DEV),
                         pp, **kw, **tol)
    np.testing.assert_array_equal(to_np(got.stats[:, 0]).astype(int),
                                  to_np(want.iter))
    flat = lambda a: to_np(a).reshape(6, -1)
    pairs = [(got.U, want.u), (got.carry.D, want.d), (got.carry.Y, want.y),
             (got.carry.G, want.g), (got.carry.Z, want.z), (got.carry.V, want.v)]
    for a, b in pairs:
        np.testing.assert_allclose(to_np(a), flat(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(to_np(ft.unpad_states(got, pp))[:, 1:],
                               to_np(want.x)[:, 1:], rtol=0, atol=1e-9)
    np.testing.assert_allclose(to_np(ft.unpad_controls(got, pp)),
                               to_np(want.u[:, 0]), rtol=0, atol=1e-9)
    if kw["check_termination"]:
        res = np.stack([to_np(getattr(want, k)) for k in (
            "primal_residual_state", "dual_residual_state",
            "primal_residual_input", "dual_residual_input")], axis=1)
        np.testing.assert_allclose(to_np(got.stats[:, 2:]), res, atol=1e-9)
        np.testing.assert_array_equal(to_np(got.stats[:, 1]) > 0.5,
                                      to_np(want.status) == atm_t.SOLVED)


def test_infinite_bounds_are_safe(quad):
    """Disabled bound sets arrive as +-inf; the clip must not produce NaN."""
    _pj, _cj, _ppj, ppt, pt, ct, x0s = quad
    inf = float("inf")
    free = pt.replace(u_min=torch.full_like(pt.u_min, -inf),
                      u_max=torch.full_like(pt.u_max, inf),
                      x_min=torch.full_like(pt.x_min, -inf),
                      x_max=torch.full_like(pt.x_max, inf))
    _, pp = torch_pp(free, ct)
    res = ft.fused_solve(torch.as_tensor(x0s), ft.FusedCarry.zeros(B, pp, device=DEV),
                         pp, max_iter=10)
    assert bool(torch.isfinite(res.U).all() and torch.isfinite(res.carry.D).all())
    assert float(res.carry.Y.abs().max()) == 0.0  # nothing clipped


def test_convert_strips_and_restores_padding(quad):
    _pj, _cj, ppj, ppt, _pt, _ct, x0s = quad
    got, want = _both(ppj, ppt, x0s, max_iter=5, check_termination=0)
    fields = jax_fused_result_fields(want)
    back = convert.fused_result_to_numpy(
        convert.fused_result_from_numpy(fields, ppt.dims, device=DEV))
    for k in ("U", "X"):
        np.testing.assert_array_equal(back[k], fields[k])
    for k in "DYGZV":
        np.testing.assert_array_equal(back["carry"][k], fields["carry"][k])
    np.testing.assert_array_equal(back["stats"][:, :6], fields["stats"][:, :6])
    assert back["stats"].shape == fields["stats"].shape == (B, 128)
    bad = dict(fields["carry"])
    bad["D"] = bad["D"].copy()
    bad["D"][0, 127] = 1.0
    with pytest.raises(ValueError, match="not zero"):
        convert.fused_carry_from_numpy(bad, ppt.dims, device=DEV)


def test_kernel_geometry():
    # flagship: operators ~52 KB, 3.3 KB per instance -> 48 instances fit
    assert ft.kernel_smem_bytes(12, 4, 10, 8) < ft.kernel_smem_bytes(12, 4, 10, 16)
    tile = ft.choose_tile((12, 4, 10), 65536)
    assert tile % ft.REGISTER_TILE == 0 and 8 <= tile <= ft.MAX_TILE
    assert ft.kernel_smem_bytes(12, 4, 10, tile) <= ft.SMEM_LIMIT_BYTES
    assert ft.kernel_smem_bytes(12, 4, 10, tile + 8) > ft.SMEM_LIMIT_BYTES \
        or tile == ft.MAX_TILE
    assert ft.choose_tile((12, 4, 10), 1) == 8          # one block, one tile
    assert ft.choose_tile((12, 4, 10), 132 * 16) == 16  # spread over the SMs
    with pytest.raises(ValueError, match="stream tier"):
        ft.choose_tile((12, 4, 64), 1024)               # long horizon


def test_what_raises_for_now(quad):
    _pj, _cj, _ppj, ppt, _pt, _ct, x0s = quad
    x, cy = torch.as_tensor(x0s), ft.FusedCarry.zeros(B, ppt, device=DEV)
    with pytest.raises(NotImplementedError, match="slice 6"):
        ft.fused_solve(x, cy, ppt, cone_ops=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        ft.fused_solve(x, cy, ppt, cone_mu_u=np.zeros((1, B)))
    with pytest.raises(NotImplementedError, match="Hopper arithmetic"):
        ft.fused_solve(x, cy, ppt, algo="bf16x3")
    with pytest.raises(ValueError, match="unknown algo"):
        ft.fused_solve(x, cy, ppt, algo="fp8")
    with pytest.raises(ValueError, match="at least one iteration"):
        ft.fused_solve(x, cy, ppt, max_iter=0)


def test_cpu_tensors_never_touch_the_kernel(quad, monkeypatch):
    _pj, _cj, _ppj, ppt, _pt, _ct, x0s = quad

    def boom():
        raise AssertionError("the CPU path must not load the CUDA library")

    monkeypatch.setattr(ft, "_library", boom)
    before = dict(ft.LAUNCH_COUNTS)
    ft.fused_solve(torch.as_tensor(x0s), ft.FusedCarry.zeros(B, ppt, device=DEV),
                   ppt, max_iter=3)
    assert ft.LAUNCH_COUNTS == before  # launches are counted at launches only
