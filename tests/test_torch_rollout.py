"""PyTorch port, fused rollouts on the CPU: ``fused_rollout`` (its plain
version) vs the JAX package's ``fused_rollout(..., interpret=True)`` and vs
``fused_mpc_rollout``, fixed, adaptive and tracking.

Bars: us / x_final / carries atol 1e-4 (the JAX tests' own bar,
tests/test_rollout_kernel.py); adaptive per-tick iteration counts agree on
>= 90 % of instance-ticks (same reason as there: float32 sums ordered
differently shift a check that sits on the tolerance)."""

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
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.api import fused_mpc_rollout, mpc_rollout
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft

from torch_parity_utils import (
    DEV, assert_fields_close, cache_to_torch, jax_fused_result_fields,
    perturbed_x0, problem_to_torch, to_np, torch_pp,
)

# ``ops.fused_rollout`` is the function in both packages; take the modules.
rj = importlib.import_module("accelerated_tinympc_tpu.ops.fused_rollout")
rt = importlib.import_module("accelerated_tinympc_tpu_torch.ops.fused_rollout")

ATOL = 1e-4
B = 6


def _build(pj, cj):
    ops_j = condensed_operators_j(cj, np.asarray(pj.A), np.asarray(pj.B),
                                  pj.horizon)
    ppj = fj.pad_problem(pj, cj, ops_j)
    pt, ct = problem_to_torch(pj), cache_to_torch(cj)
    _, ppt = torch_pp(pt, ct)
    return ppj, rj.rollout_ops(pj, ppj), pt, ct, ppt, rt.rollout_ops(pt, ppt, device=DEV)


@pytest.fixture(scope="module")
def quad():
    pj, cj, x0 = atm_j.models.quadrotor_hovering_setup()
    x0s = perturbed_x0(x0, B, seed=0, spread=0.05).astype(np.float32)
    return (pj, cj) + _build(pj, cj) + (x0s,)


def _both(quad, T, const=None, **kw):
    pj, cj, ppj, ropsj, pt, ct, ppt, ropst, x0s = quad
    jkw, tkw = dict(kw), dict(kw)
    if const is not None:
        jkw["const_seq"], tkw["const_seq"] = const
    want = rj.fused_rollout(jnp.asarray(x0s), fj.FusedCarry.zeros(B, ppj), ppj,
                            ropsj, T, interpret=True, batch_tile=B, **jkw)
    got = rt.fused_rollout(torch.as_tensor(x0s),
                           ft.FusedCarry.zeros(B, ppt, device=DEV), ppt,
                           ropst, T, **tkw)
    return got, want


def _final_close(got, want, dims, rows=slice(None)):
    wt = convert.fused_result_from_numpy(
        jax_fused_result_fields(want.final), dims, device=DEV)
    for k in ("D", "Y", "G", "Z", "V"):
        np.testing.assert_allclose(
            to_np(getattr(got.final.carry, k))[rows],
            to_np(getattr(wt.carry, k))[rows], rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(to_np(got.final.U)[rows], to_np(wt.U)[rows],
                               rtol=0, atol=ATOL)


def test_fixed_matches_jax(quad):
    got, want = _both(quad, 5, max_iter=25)
    np.testing.assert_allclose(to_np(got.us), np.asarray(want.us), atol=ATOL)
    np.testing.assert_allclose(to_np(got.x_final), np.asarray(want.x_final),
                               atol=ATOL)
    _final_close(got, want, quad[6].dims)
    assert got.us.shape == (5, B, 4) and got.iters.shape == (5, B)
    assert got.iters.dtype == torch.int32 and bool((got.iters == 25).all())


@pytest.mark.parametrize("check", [1, 5])
def test_adaptive_matches_jax(quad, check):
    got, want = _both(quad, 8, max_iter=40, check_termination=check,
                      abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    it_g, it_w = to_np(got.iters), np.asarray(want.iters).astype(np.int32)
    assert (it_g == it_w).mean() >= 0.9, (it_g, it_w)
    assert it_g.min() < 40  # early exits happened
    same = (it_g == it_w).all(axis=0)
    assert same.any()
    np.testing.assert_allclose(to_np(got.us)[:, same],
                               np.asarray(want.us)[:, same], atol=ATOL)
    np.testing.assert_allclose(to_np(got.x_final)[same],
                               np.asarray(want.x_final)[same], atol=ATOL)
    _final_close(got, want, quad[6].dims, same)


def test_tracking_matches_jax():
    pj, cj, x0, Xref_total = atm_j.models.quadrotor_tracking_setup()
    built = _build(pj, cj)
    ppj, pt, ct, ppt = built[0], built[2], built[3], built[4]
    x0s = perturbed_x0(x0, B, seed=1, spread=0.02).astype(np.float32)
    T = 5
    cs_j = rj.rollout_const_seq(ppj, pj.Q, cj.Pinf,
                                jnp.asarray(Xref_total, jnp.float32), T)
    cs_t = rt.rollout_const_seq(ppt, pt.Q, ct.Pinf, Xref_total, T)
    np.testing.assert_allclose(to_np(cs_t), np.asarray(cs_j)[:, :36], atol=1e-4)
    got, want = _both((pj, cj) + built + (x0s,), T, const=(cs_j, cs_t),
                      max_iter=25)
    np.testing.assert_allclose(to_np(got.us), np.asarray(want.us), atol=ATOL)
    np.testing.assert_allclose(to_np(got.x_final), np.asarray(want.x_final),
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "tracking"])
@pytest.mark.parametrize("in_kernel", [False, True], ids=["tick_loop", "one_call"])
def test_fused_mpc_rollout_matches_jax(mode, in_kernel):
    """``fused_mpc_rollout`` (both routes) vs the JAX package's, and the two
    routes of the port against each other."""
    from accelerated_tinympc_tpu.api import fused_mpc_rollout as rollout_j

    T, n = 4, 3
    kw = dict(max_iter=20)
    if mode == "tracking":
        pj, cj, x0, Xref_total = atm_j.models.quadrotor_tracking_setup()
    else:
        pj, cj, x0 = atm_j.models.quadrotor_hovering_setup()
        Xref_total = None
    if mode == "adaptive":
        kw = dict(max_iter=40, check_termination=1, abs_pri_tol=1e-2,
                  abs_dua_tol=1e-2)
    ppj, _ropsj, pt, ct, ppt, _ropst = _build(pj, cj)
    x0s = perturbed_x0(x0, n, seed=2, spread=0.02).astype(np.float32)
    jref = {} if Xref_total is None else dict(
        Xref_total=jnp.asarray(Xref_total, jnp.float32), Pinf=cj.Pinf)
    tref = {} if Xref_total is None else dict(
        Xref_total=Xref_total, Pinf=ct.Pinf)
    xf_j, us_j, carry_j = rollout_j(
        ppj, jnp.asarray(x0s), T, problem=pj, batch_tile=n, interpret=True,
        in_kernel=in_kernel, **kw, **jref)
    xf_t, us_t, carry_t = fused_mpc_rollout(
        ppt, torch.as_tensor(x0s), T, problem=pt, in_kernel=in_kernel,
        **kw, **tref)
    tol = ATOL if mode != "adaptive" else 2e-2  # early exit promises its tol
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j), atol=tol)
    np.testing.assert_allclose(to_np(xf_t), np.asarray(xf_j), atol=tol)
    # the two routes of the port, in float64: the tick loop and the one-call
    # mission run their products at different batch shapes, and the CPU's
    # BLAS groups float32 sums by that shape (1e-6-1e-5 apart there)
    f64 = torch.float64
    pt64, ct64 = problem_to_torch(pj, f64), cache_to_torch(cj, f64)
    _, ppt64 = torch_pp(pt64, ct64, f64)
    ref64 = {} if Xref_total is None else dict(
        Xref_total=Xref_total, Pinf=ct64.Pinf)
    x0_64 = torch.as_tensor(x0s, dtype=f64)
    routes = [fused_mpc_rollout(ppt64, x0_64, T, problem=pt64, in_kernel=k,
                                **kw, **ref64)
              for k in (in_kernel, not in_kernel)]
    (xf_a, us_a, carry_a), (xf_b, us_b, carry_b) = routes
    assert_fields_close({"us": us_a, "x_final": xf_a},
                        {"us": us_b, "x_final": xf_b}, atol=1e-12,
                        scaled=True)
    assert_fields_close(carry_a, carry_b, atol=1e-12, scaled=True)


def test_rollout_equals_scan_tier_f64():
    """The fused mission follows the scan tier's early-exiting mission tick
    for tick in float64: same counts, same controls."""
    tdt = torch.float64
    p, c, x0 = atm_t.models.quadrotor_hovering_setup(dtype=tdt, device=DEV)
    x0s = torch.as_tensor(perturbed_x0(x0, 4, seed=3, spread=0.05))
    settings = atm_t.Settings(max_iter=60, check_termination=1,
                              abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    _, xf_s, trace = mpc_rollout(p, c, settings, x0s, 8, batched=True)
    _, pp = torch_pp(p, c, tdt)
    res = rt.fused_rollout(
        x0s, ft.FusedCarry.zeros(4, pp, tdt, DEV), pp,
        rt.rollout_ops(p, pp, tdt, DEV), 8, max_iter=60, check_termination=1,
        abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    np.testing.assert_array_equal(to_np(res.iters), to_np(trace.iters))
    np.testing.assert_allclose(to_np(res.us), to_np(trace.u), atol=1e-9)
    np.testing.assert_allclose(to_np(res.x_final), to_np(xf_s), atol=1e-9)


def test_continuation_equals_one_run(quad):
    """Rollout T=6 == rollout T=4 then T=2 continued from (x_final, carry)."""
    ppt, ropst, x0s = quad[6], quad[7], torch.as_tensor(quad[8])
    zero = ft.FusedCarry.zeros(B, ppt, device=DEV)
    full = rt.fused_rollout(x0s, zero, ppt, ropst, 6, max_iter=20)
    head = rt.fused_rollout(x0s, zero, ppt, ropst, 4, max_iter=20)
    tail = rt.fused_rollout(head.x_final, head.final.carry, ppt, ropst, 2,
                            max_iter=20)
    np.testing.assert_allclose(to_np(tail.x_final), to_np(full.x_final), atol=1e-6)
    np.testing.assert_allclose(to_np(tail.us), to_np(full.us[4:]), atol=1e-6)


def test_rollout_argument_checks(quad):
    ppt, ropst, x0s = quad[6], quad[7], torch.as_tensor(quad[8])
    zero = ft.FusedCarry.zeros(B, ppt, device=DEV)
    with pytest.raises(ValueError, match="at least one tick"):
        rt.fused_rollout(x0s, zero, ppt, ropst, 0)
    with pytest.raises(ValueError, match="at least one iteration"):
        rt.fused_rollout(x0s, zero, ppt, ropst, 2, max_iter=0)
    with pytest.raises(ValueError, match="const_seq must be"):
        rt.fused_rollout(x0s, zero, ppt, ropst, 3,
                         const_seq=torch.zeros((2, 36)))
    # Cones are taken now (cone_ops from pad_cones); a cone that indexes
    # outside its knot is refused where the operands are built.
    from accelerated_tinympc_tpu_torch.solver.cones import Cone, ConeSet
    with pytest.raises(ValueError, match="axis is in the ball"):
        ft.pad_cones(ppt, ConeSet(state_cones=(Cone((0, 2), 2, 1.0),)))
    tilt = ft.pad_cones(ppt, ConeSet(input_cones=(Cone((1, 2), 0, 0.5),)))
    with pytest.raises(ValueError, match="at least one tick"):
        rt.fused_rollout(x0s, zero, ppt, ropst, 0, cone_ops=tilt)
    with pytest.raises(ValueError, match="unknown algo"):
        rt.fused_rollout(x0s, zero, ppt, ropst, 2, algo="fp8")
