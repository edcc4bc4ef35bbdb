"""PyTorch port, the fused tier's split-bf16 mode (``algo="bf16x3"``,
``polish``) on the CPU: the plain versions (``fused_solve_plain``,
``fused_rollout_plain``; on the card the ``mma.sync`` kernels of
``ops/csrc/fused_admm_bf16x3.cu``, held in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``) vs the JAX package's ``fused_solve(..., algo="bf16x3",
interpret=True)`` as tests/test_fused.py runs it, on the same seeded inputs.

The split is discontinuous: an iterate that two float32 implementations
round one ulp apart may split into other (hi, lo) pairs, which moves that
product by up to 2^-17 of its terms, as far as the split mode's own error.
So the schedule is pinned on short solves, where both packages still round
alike, by how much closer the port sits to JAX's bf16x3 result than to JAX's
float32 one; long solves are held to the JAX tests' own bars. One module
fixture runs every JAX solve (about 20 s in all)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.ops import fused_admm as fj
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
)
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched as init_batched_j, solve_batched as solve_batched_j,
)
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft
from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve
from accelerated_tinympc_tpu_torch.utils import profiling

from torch_parity_utils import (
    DEV, cache_to_torch, lander_pair, perturbed_x0, problem_to_torch, to_np,
    torch_pp,
)

rj = importlib.import_module("accelerated_tinympc_tpu.ops.fused_rollout")
rt = importlib.import_module("accelerated_tinympc_tpu_torch.ops.fused_rollout")

B = 8
ATOL = 1e-4        # the JAX tests' parity bar between float32 tiers
SCHEDULE_TOL = 2e-6   # of max |U|: the port vs JAX's bf16x3, short solves
SEPARATION = 10.0     # JAX's float32 result at least this much farther
# The short solves that pin the schedules: fixed at polish 1 and 2, and an
# adaptive one with a warmup and checks between split iterations.
SHORT = {
    "fixed polish=1": dict(max_iter=5, polish=1),
    "fixed polish=2": dict(max_iter=6, polish=2),
    "adaptive": dict(max_iter=7, check_termination=2, warmup_iters=1),
}
ADAPTIVE_05 = dict(max_iter=400, check_termination=5, abs_pri_tol=0.05,
                   abs_dua_tol=0.05)   # tests/test_fused.py's adaptive case
# ... at 20 instances (its 8 and 12 more from the same seed): a check that
# sits on the tolerance may freeze one check apart in two implementations,
# and the port's fused bar is a share of instances, 90 %.
B_ADAPTIVE = 20
# Near the hover reference, where float32 solves converge within 20
# iterations: the mode's checks are float32 iterations after split ones, so
# a check's dual residual holds the switch of arithmetic and floors between
# 2e-3 and 1e-2, over a tolerance of 1e-3 (the JAX package's mode alike).
FLOOR = dict(max_iter=120, check_termination=5, abs_pri_tol=1e-3,
             abs_dua_tol=1e-3)
ROLLOUT = {"fixed": (4, dict(max_iter=20, polish=6)),
           "adaptive": (8, dict(max_iter=40, check_termination=2,
                                abs_pri_tol=1e-2, abs_dua_tol=1e-2))}
LANDER = dict(max_iter=60, polish=8)


def _jax_solve(ppj, x0s, **kw):
    return fj.fused_solve(jnp.asarray(x0s), fj.FusedCarry.zeros(
        x0s.shape[0], ppj), ppj, batch_tile=x0s.shape[0], interpret=True,
        **kw)


def _port_solve(ppt, x0s, **kw):
    x = torch.as_tensor(x0s)
    return ft.fused_solve(x, ft.FusedCarry.zeros(
        x.shape[0], ppt, dtype=x.dtype, device=DEV), ppt, **kw)


def _u(res, n=36):
    return np.asarray(to_np(res.U))[:, :n]


@pytest.fixture(scope="module")
def oracle():
    """Every JAX result the tests read, computed once."""
    pj, cj, x0 = atm_j.models.quadrotor_hovering_setup()
    ppj = fj.pad_problem(pj, cj, condensed_operators_j(
        cj, np.asarray(pj.A), np.asarray(pj.B), pj.horizon))
    pt, ct = problem_to_torch(pj), cache_to_torch(cj)
    _, ppt = torch_pp(pt, ct)
    x0s = perturbed_x0(x0, B, seed=7).astype(np.float32)
    out = {"pj": pj, "cj": cj, "ppj": ppj, "pt": pt, "ct": ct, "ppt": ppt,
           "x0": np.asarray(x0), "x0s": x0s}
    for name, kw in SHORT.items():
        out[name] = (_u(_jax_solve(ppj, x0s, algo="bf16x3", **kw)),
                     _u(_jax_solve(ppj, x0s, **kw)))
    out["fixed100"] = _u(_jax_solve(ppj, x0s, max_iter=100,
                                    algo="bf16x3", polish=8))
    st = init_batched_j(B, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0s)))
    scan = solve_batched_j(st, pj, cj, atm_j.Settings(
        max_iter=100, check_termination=0))
    out["scan100"] = np.asarray(scan.u).reshape(B, 36)
    out["x0s20"] = perturbed_x0(x0, B_ADAPTIVE, seed=7).astype(np.float32)
    out["adaptive05"] = _jax_solve(ppj, out["x0s20"], algo="bf16x3",
                                   **ADAPTIVE_05)
    out["x0hover"] = (np.asarray(pj.Xref)[0][None] + 0.02 * np.random.
                      default_rng(1).standard_normal((B, 12))).astype(
                          np.float32)
    out["floor"] = _jax_solve(ppj, out["x0hover"], algo="bf16x3", **FLOOR)
    ropsj = rj.rollout_ops(pj, ppj)
    xr = perturbed_x0(x0, B, seed=0, spread=0.05).astype(np.float32)
    out["xr"] = xr
    for name, (ticks, kw) in ROLLOUT.items():
        out["rollout " + name] = rj.fused_rollout(
            jnp.asarray(xr), fj.FusedCarry.zeros(B, ppj), ppj, ropsj, ticks,
            interpret=True, batch_tile=B, algo="bf16x3", **kw)
    lpj, lcj, lcones_j, lpt, lct, lcones_t = lander_pair(15)
    lppj = fj.pad_problem(lpj, lcj, condensed_operators_j(
        lcj, np.asarray(lpj.A), np.asarray(lpj.B), 15))
    lx = perturbed_x0(np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0]), B,
                      seed=3, spread=0.3).astype(np.float32)
    out["lander"] = (lpt, lct, lcones_t, lx, _u(_jax_solve(
        lppj, lx, cone_ops=fj.pad_cones(lppj, lcones_j), algo="bf16x3",
        **LANDER), 42))
    mpc = atm_j.TinyMPC.from_parts(
        pj, cj, settings=atm_j.Settings(max_iter=50, check_termination=0),
        tier="fused", interpret=True, algo="bf16x3")
    mpc.set_x0(jnp.asarray(x0, jnp.float32))
    mpc.solve()
    out["tinympc"] = np.asarray(mpc.get_u())
    return out


def test_split_and_dot3_are_jax_arithmetic():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((36, 156)) * 10.0 ** rng.integers(
        -3, 3, (36, 156))).astype(np.float32)
    hj, lj = fj._split_bf16(jnp.asarray(w))
    ht, lt = ft.split_bf16(torch.as_tensor(w))
    bits_t = lambda a: a.view(torch.int16).numpy().view(np.uint16)
    bits_j = lambda a: (np.asarray(a.astype(jnp.float32)).view(np.uint32)
                        >> 16).astype(np.uint16)
    np.testing.assert_array_equal(bits_t(ht), bits_j(hj))
    np.testing.assert_array_equal(bits_t(lt), bits_j(lj))
    x = rng.standard_normal((8, 36)).astype(np.float32)
    want = np.asarray(fj._dot3(jnp.asarray(x), (hj, lj)))
    got = ft.dot3(torch.as_tensor(x), (ht, lt)).numpy()
    # the same exact bf16 products, summed in float32 in other orders
    terms = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
    assert np.all(np.abs(got - want) <= 36 * 2.0 ** -24 * terms)
    # and the split mode's own error: the dropped lo lo term and the
    # iterate's split, some 2^-16 of the terms
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert np.all(np.abs(got - exact) <= 2.0 ** -15 * terms)


def test_schedules_are_the_jax_packages(oracle):
    for name, kw in SHORT.items():
        want3, want32 = oracle[name]
        got = _u(_port_solve(oracle["ppt"], oracle["x0s"], algo="bf16x3",
                             **kw))
        scale = np.abs(want3).max()
        err = np.abs(got - want3).max() / scale
        off = np.abs(want32 - want3).max() / scale
        assert err <= SCHEDULE_TOL, (name, err)
        assert off >= SEPARATION * err, (name, err, off)
        # the iterations the schedule splits are the JAX package's
        fixed = kw.get("check_termination", 0) == 0
        splits = [ft.split_iteration(it, algo="bf16x3", **kw)
                  for it in range(1, kw["max_iter"] + 1)]
        if fixed:
            n3 = kw["max_iter"] - kw["polish"]
            assert splits == [True] * n3 + [False] * kw["polish"]
        else:   # warmup 1, checks every 2: f32 at the checks and the cap
            assert splits == [True, False, True, False, True, False, False]
    # a launch whose schedule splits no iteration lays the kernel's shared
    # memory out without the split operators (schedule_splits)
    for mi in range(1, 9):
        for ce in range(0, 4):
            for w in range(0, 3):
                for pol in range(0, 10):
                    kw = dict(max_iter=mi, check_termination=ce,
                              warmup_iters=w, polish=pol)
                    assert ft.schedule_splits("bf16x3", **kw) == any(
                        ft.split_iteration(it, algo="bf16x3", **kw)
                        for it in range(1, mi + 1)), kw


def test_fixed_100_at_polish_8_matches_jax_and_the_scan_tier(oracle):
    got = _u(_port_solve(oracle["ppt"], oracle["x0s"], max_iter=100,
                         algo="bf16x3", polish=8))
    assert np.abs(got - oracle["fixed100"]).max() < ATOL
    assert np.abs(got - oracle["scan100"]).max() < ATOL


def test_adaptive_check5_keeps_the_jax_bars(oracle):
    ppt, x0s = oracle["ppt"], oracle["x0s20"]
    got = _port_solve(ppt, x0s, algo="bf16x3", **ADAPTIVE_05)
    f32 = _port_solve(ppt, x0s, **ADAPTIVE_05)
    s3 = to_np(got.stats)
    want = np.asarray(oracle["adaptive05"].stats)[:, :2]
    # the JAX test's 8 instances all converge; of the 12 more one stays
    # unconverged at the cap in both packages and in both modes
    assert np.all(s3[:B, 1] == 1.0)
    np.testing.assert_array_equal(s3[:, 1], want[:, 1])
    solved = s3[:, 1] == 1.0
    assert np.all(s3[solved, 2:6] < 0.05 + 1e-6)   # float32 check residuals
    assert (s3[:, 0] == want[:, 0]).mean() >= 0.9, (s3[:, 0], want[:, 0])
    # controls within 5e-4 of the float32 mode where the two freeze at the
    # same check (elsewhere each is within its tolerance of the solution)
    same = s3[:, 0] == to_np(f32.stats)[:, 0]
    assert same.mean() >= 0.9
    assert np.abs(_u(got) - _u(f32))[same].max() < 5e-4
    # the mode's residual floor, in both packages: float32 converges, the
    # split mode runs to the cap with the same residuals as JAX's
    x = oracle["x0hover"]
    f32 = to_np(_port_solve(ppt, x, **FLOOR).stats)
    got = to_np(_port_solve(ppt, x, algo="bf16x3", **FLOOR).stats)
    want = np.asarray(oracle["floor"].stats)[:, :6]
    assert np.all(f32[:, 1] == 1.0) and np.all(f32[:, 0] <= 20)
    assert np.all(got[:, 1] == 0.0) and np.all(want[:, 1] == 0.0)
    assert 2e-3 < got[:, 3].max() < 1e-2
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0.05, atol=1e-5)


def test_lander_with_cones_matches_jax(oracle):
    lpt, lct, cones_t, lx, want = oracle["lander"]
    _, lpp = torch_pp(lpt, lct)
    got = _u(_port_solve(lpp, lx, cone_ops=ft.pad_cones(lpp, cones_t),
                         algo="bf16x3", **LANDER), 42)
    f32 = _u(_port_solve(lpp, lx, cone_ops=ft.pad_cones(lpp, cones_t),
                         **LANDER), 42)
    assert np.abs(got - want).max() < ATOL
    assert np.abs(got - f32).max() > 0     # the split mode really ran


@pytest.mark.parametrize("mode", list(ROLLOUT))
def test_fused_rollout_matches_jax(oracle, mode):
    ppt, pt, xr = oracle["ppt"], oracle["pt"], oracle["xr"]
    want = oracle["rollout " + mode]
    ticks, kw = ROLLOUT[mode]
    got = rt.fused_rollout(
        torch.as_tensor(xr), ft.FusedCarry.zeros(B, ppt, device=DEV), ppt,
        rt.rollout_ops(pt, ppt, device=DEV), ticks, algo="bf16x3", **kw)
    it_g, it_w = to_np(got.iters), np.asarray(want.iters)
    assert (it_g == it_w).mean() >= 0.9
    same = (it_g == it_w).all(axis=0)
    np.testing.assert_allclose(to_np(got.us)[:, same],
                               np.asarray(want.us)[:, same], atol=ATOL,
                               rtol=0)
    # The plant state is the plant stepped with those controls (B reaches
    # 15, so it carries the controls' split-mode rounding 15-fold): held
    # to the trace, in float64.
    A, Bm = (np.asarray(to_np(m), np.float64) for m in (pt.A, pt.B))
    x = xr.astype(np.float64)
    for t in range(ticks):
        x = x @ A.T + np.asarray(to_np(got.us)[t], np.float64) @ Bm.T
    np.testing.assert_allclose(to_np(got.x_final), x, atol=1e-5, rtol=0)


def test_tinympc_bf16x3_matches_jax(oracle):
    mpc = atm_t.TinyMPC.from_parts(
        oracle["pt"], oracle["ct"], settings=atm_t.Settings(
            max_iter=50, check_termination=0), tier="fused", algo="bf16x3",
        device=DEV)
    mpc.set_x0(oracle["x0"])
    mpc.solve()
    assert np.abs(mpc.get_u() - oracle["tinympc"]).max() < ATOL
    # the stored algo reaches the fused calls: the in-kernel mission and
    # the tick loop take it too
    _xf, us_k = mpc.rollout(3, in_kernel=True)
    assert np.isfinite(to_np(us_k)).all() and us_k.shape == (3, 4)


def test_cascade_equals_one_call_in_float64(oracle):
    # the cascade's segments end on checks, so the split schedule of its
    # launches composes to one call's (float64: the CPU's BLAS groups
    # float32 sums by batch shape)
    f64 = torch.float64
    _, pp64 = torch_pp(problem_to_torch(oracle["pj"], f64),
                       cache_to_torch(oracle["cj"], f64), f64)
    x = torch.as_tensor(oracle["x0s"], dtype=f64)
    kw = dict(ADAPTIVE_05, algo="bf16x3")
    zero = ft.FusedCarry.zeros(B, pp64, dtype=f64, device=DEV)
    segments = []
    casc = cascade_solve(x, zero, pp64, segment_iters=10, trace=segments,
                         **kw)
    one = ft.fused_solve(x, zero, pp64, **kw)
    assert len(segments) > 1 and segments[-1][1] < B
    assert torch.equal(casc.stats[:, :2], one.stats[:, :2])
    for a, b in zip((casc.U, casc.X) + tuple(casc.carry),
                    (one.U, one.X) + tuple(one.carry)):
        assert (a - b).abs().max() <= 1e-12 * max(1.0, b.abs().max())


def test_without_split_iterations_the_f32_bits(oracle):
    ppt, x0s = oracle["ppt"], oracle["x0s"]
    fields = lambda r: (r.U, r.X, r.stats) + tuple(r.carry)
    for kw3, kw in ((dict(polish=30), dict()),
                    (dict(check_termination=1), dict(check_termination=1))):
        a = _port_solve(ppt, x0s, max_iter=30, algo="bf16x3", **kw3)
        b = _port_solve(ppt, x0s, max_iter=30, **kw)
        assert all(torch.equal(p, q) for p, q in zip(fields(a), fields(b)))


def test_float64_takes_the_same_splits_with_float64_sums(oracle):
    # The JAX fused tier has no float64. The port's plain version splits
    # float64 operands into the same bf16 pairs and sums in float64: it sits
    # beside the float32 split result, and apart from the float64 f32 mode.
    f64 = torch.float64
    _, pp64 = torch_pp(problem_to_torch(oracle["pj"], f64),
                       cache_to_torch(oracle["cj"], f64), f64)
    x = oracle["x0s"].astype(np.float64)
    w = torch.as_tensor(x[:, :12] @ np.ones((12, 36)) * 1e-2)
    h64, l64 = ft.split_bf16(w)
    h32, l32 = ft.split_bf16(w.float())
    assert h64.dtype == torch.bfloat16 and torch.equal(h64, h32)
    kw = dict(max_iter=20, polish=4)
    got = _u(_port_solve(pp64, x, algo="bf16x3", **kw))
    f32 = _u(_port_solve(oracle["ppt"], oracle["x0s"], algo="bf16x3", **kw))
    plain = _u(_port_solve(pp64, x, **kw))
    assert got.dtype == np.float64
    assert np.abs(got - f32).max() < ATOL
    assert np.abs(got - plain).max() > 1e-9
    with pytest.raises(ValueError, match="unknown algo"):
        _port_solve(pp64, x, algo="bf16", **kw)


def test_solve_bound_and_layout_of_the_split_mode():
    # solve_bound by hand at the flagship: 2 (Du Dx + Du^2 + Dx Du + Du^2)
    # = 22,464 FLOP an instance-iteration; the x0 products 2 nx Dz = 3,744
    dims, n = (12, 4, 10), 1000
    fp32 = (100 * n * 22464 + n * 3744) / 67e12
    ms, by = profiling.solve_bound(dims, 100 * n, n, n)
    assert by == "operations" and ms == pytest.approx(1e3 * fp32)
    split = ((8 * n * 22464 + n * 3744) / 67e12 + 3 * 92 * n * 22464 / 989e12)
    ms, by = profiling.solve_bound(dims, 100 * n, n, n, split_iters=92 * n)
    assert by == "operations" and ms == pytest.approx(1e3 * split)
    assert profiling.split_iters_of([100] * n, max_iter=100, polish=8) \
        == 92 * n
    # adaptive, checks every 5 after a warmup of 2, cap 12: split at 1-4,
    # 6-9, 11; an instance stopping at 10 ran 8 split iterations
    assert profiling.split_iters_of(
        [10, 12], max_iter=12, check_termination=5, warmup_iters=2) == 8 + 9
    # the split kernels' operator fragments: hi and lo of Wf^T in 10 x 3
    # tiles, of Wb^T in 3 x 10, 256 words a tile. With the operators staged,
    # Wb^T's fragments take the place of the float32 Wb and Wx (read from
    # device memory then) and Wf^T's stay in device memory; one flag a slot
    assert ft.split_words(*dims) == 256 * (10 * 3 + 3 * 10) == 15360
    assert ft.kernel_smem_bytes(*dims, 48, split=True) \
        == ft.kernel_smem_bytes(*dims, 48) + 4 * (
            48 + 256 * 3 * 10 - 156 * 36 - 12 * 156) == 225_712
    assert ft.kernel_smem_bytes(*dims, 48, placement="device", split=True) \
        == ft.kernel_smem_bytes(*dims, 48, placement="device") + 4 * 48
    assert ft.choose_tile(dims, 65536, split=True) == 48
    assert ft.choose_placement((12, 4, 18), split=True) == "shared"
    assert ft.choose_placement((12, 4, 19), split=True) == "device"
    for N in (79, 129, 150):   # every horizon the float32 kernels take
        assert ft.choose_tile((12, 4, N), 65536, split=True) == 4
