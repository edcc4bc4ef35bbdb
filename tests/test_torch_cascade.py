"""PyTorch port, compaction cascade on the CPU: ``cascade_solve`` is
iteration-exact against one adaptive ``fused_solve`` call in float64 (equal
counts and flags, values to 1e-12 of each field's largest entry), with cones
and per-instance cone rows too, and agrees with the JAX package's
``cascade_solve`` (interpret mode) on the same inputs in float32 at the fused
tiers' 1e-4 bar.

The two port routes are held in float64: compaction changes the batch shape
of every matrix product, and the CPU's BLAS groups float32 sums by that shape,
so two float32 routes sit a few 1e-6 apart and an adaptive check that lands on
the tolerance can flip. In float64 they agree to ~1e-14."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_tinympc_tpu.models import quadrotor_hovering_setup as hovering_j
from accelerated_tinympc_tpu.ops import fused_admm as fj
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
)
from accelerated_tinympc_tpu.solver.cascade import cascade_solve as cascade_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft
from accelerated_tinympc_tpu_torch.solver import cascade as ct_mod
from accelerated_tinympc_tpu_torch.solver.cascade import cascade_solve

from torch_parity_utils import (
    DEV, LANDER_X0, assert_fused_close, cache_to_torch, lander_pair,
    perturbed_x0, problem_to_torch, to_np, torch_pp,
)

B = 12
TOL = dict(abs_pri_tol=0.05, abs_dua_tol=0.05)


@pytest.fixture(scope="module")
def quad():
    pj, cj, x0 = hovering_j()
    ops_j = condensed_operators_j(cj, np.asarray(pj.A), np.asarray(pj.B),
                                  pj.horizon)
    ppj = fj.pad_problem(pj, cj, ops_j)
    _, ppt = torch_pp(problem_to_torch(pj), cache_to_torch(cj))
    f64 = torch.float64
    _, ppt64 = torch_pp(problem_to_torch(pj, f64), cache_to_torch(cj, f64),
                        f64)
    # around the hover reference at distances from 0.01 to 1: the instances
    # need between 8 and more than 80 iterations
    rng = np.random.default_rng(5)
    x0s = np.asarray(pj.Xref)[0][None] + (
        np.geomspace(0.01, 1.0, B)[:, None] * rng.standard_normal((B, 12)))
    return ppj, ppt, x0s.astype(np.float32), ppt64


def _exact(got, want):
    """Equal counts and flags; every field within 1e-12 of its largest entry
    (float64 routes that differ only in the batch shape of their products)."""
    assert torch.equal(got.stats[:, :2], want.stats[:, :2])
    for a, b in [(got.U, want.U), (got.X, want.X), (got.stats[:, 2:],
                 want.stats[:, 2:])] + list(zip(got.carry, want.carry)):
        assert float((a - b).abs().max()) <= 1e-12 * max(
            1.0, float(b.abs().max()))


CASES = {
    "check1_seg10": dict(check_termination=1, segment_iters=10),
    "check5_seg10_growth1": dict(check_termination=5, segment_iters=10,
                                 segment_growth=1.0),
    "check2_seg6_warmup3": dict(check_termination=2, segment_iters=6,
                                warmup_iters=3, segment_growth=2.0),
    "default_segment": dict(check_termination=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cascade_is_iteration_exact(quad, case):
    _ppj, _ppt, x0s, ppt = quad
    kw = dict(CASES[case])
    seg = {k: kw.pop(k) for k in ("segment_iters", "segment_growth")
           if k in kw}
    x0 = torch.as_tensor(x0s, dtype=torch.float64)
    cold = ft.FusedCarry.zeros(B, ppt, torch.float64, DEV)
    one = ft.fused_solve(x0, cold, ppt, max_iter=80, **TOL, **kw)
    trace = []
    got = cascade_solve(x0, cold, ppt, max_iter=80, trace=trace, **TOL, **kw,
                        **seg)
    _exact(got, one)
    it = to_np(one.stats[:, 0])
    assert len(set(it.tolist())) > 2            # the exits really diverge
    sizes = [n for _k, n in trace]
    assert sizes[0] == B and sizes == sorted(sizes, reverse=True)
    assert len(trace) > 1 and sizes[-1] < B     # survivors were compacted
    assert sum(k for k, _n in trace) <= 80


def test_cascade_with_cones_and_per_instance_rows():
    f64 = torch.float64
    _pj, _cj, _cones_j, pt, cache_t, cones_t = lander_pair(8, dtype=np.float64)
    _, ppt = torch_pp(pt, cache_t, f64)
    cops = ft.pad_cones(ppt, cones_t)
    x0s = perturbed_x0(LANDER_X0, B, seed=3, spread=0.3)
    x0s *= np.linspace(0.2, 1.5, B)[:, None]
    x0 = torch.as_tensor(x0s.astype(np.float32), dtype=f64)
    cold = ft.FusedCarry.zeros(B, ppt, f64, DEV)
    kw = dict(max_iter=90, check_termination=2, abs_pri_tol=3e-2,
              abs_dua_tol=3e-2, cone_ops=cops,
              cone_mu_u=torch.linspace(0.6, 1.4, B, dtype=f64)[None],
              cone_shift_x=torch.linspace(0.05, 0.2, B, dtype=f64)[None])
    one = ft.fused_solve(x0, cold, ppt, **kw)
    trace = []
    got = cascade_solve(x0, cold, ppt, segment_iters=10, trace=trace, **kw)
    _exact(got, one)
    assert len(trace) > 1 and trace[-1][1] < B


def test_cascade_matches_jax_cascade(quad):
    ppj, ppt, x0s, _ppt64 = quad
    kw = dict(max_iter=60, check_termination=1, segment_iters=20, **TOL)
    want = cascade_j(jnp.asarray(x0s), fj.FusedCarry.zeros(B, ppj), ppj,
                     batch_tile=B, interpret=True, **kw)
    got = cascade_solve(torch.as_tensor(x0s),
                        ft.FusedCarry.zeros(B, ppt, device=DEV), ppt, **kw)
    it_g, it_w = to_np(got.stats[:, 0]), np.asarray(want.stats[:, 0])
    same = it_g == it_w
    assert same.mean() >= 0.9, (it_g, it_w)
    np.testing.assert_array_equal(to_np(got.stats[:, 1])[same],
                                  np.asarray(want.stats[:, 1])[same])
    wt = assert_fused_close  # values on the instances with equal schedules
    g = ft.FusedResult(got.U[same], got.X[same],
                       ft.FusedCarry(*(a[same] for a in got.carry)),
                       got.stats[same])
    w = fj.FusedResult(want.U[same], want.X[same],
                       fj.FusedCarry(*(a[same] for a in want.carry)),
                       want.stats[same])
    wt(g, w, ppt.dims, atol=1e-4)


def test_short_solve_is_one_call_and_validation(quad):
    _ppj, ppt, x0s, _ppt64 = quad
    x0 = torch.as_tensor(x0s)
    cold = ft.FusedCarry.zeros(B, ppt, device=DEV)
    trace = []
    got = cascade_solve(x0, cold, ppt, max_iter=10, check_termination=1,
                        segment_iters=10, trace=trace, **TOL)
    assert trace == [(10, B)]
    _exact(got, ft.fused_solve(x0, cold, ppt, max_iter=10,
                               check_termination=1, **TOL))
    with pytest.raises(ValueError, match="requires adaptive mode"):
        cascade_solve(x0, cold, ppt, check_termination=0)
    with pytest.raises(ValueError, match="multiple of"):
        cascade_solve(x0, cold, ppt, check_termination=4, segment_iters=10)
    with pytest.raises(ValueError, match="warmup_iters must be"):
        cascade_solve(x0, cold, ppt, segment_iters=10, warmup_iters=10)
    with pytest.raises(ValueError, match="segment_growth"):
        cascade_solve(x0, cold, ppt, segment_iters=10, segment_growth=0.5)


@pytest.mark.parametrize("name", ["fleet_tier_hstream",
                                  "stream_cascade_solve",
                                  "hstream_cascade_solve"])
def test_other_cascades_wait_for_their_kernels(name):
    """The stream and hstream cascades, and the fleet tier that runs the
    hstream one, waited for their kernels; they are ported now
    (tests/test_torch_stream.py, test_torch_hstream.py), so each case holds
    what is refused there: the fleet setup's mesh= (the JAX fleet's setup
    takes none either), a segment off the check cadence, a shrinking
    segment."""
    z = np.zeros((2, 3, 3))
    if name == "fleet_tier_hstream":
        f = atm_t.TinyMPCFleet.setup(
            z, np.zeros((2, 3, 1)), np.ones((2, 3)), np.ones((2, 1)),
            1.0, 5, tier="hstream", device=DEV)
        assert f._hp.dims == (3, 1, 5)
        with pytest.raises(TypeError, match="mesh"):   # as JAX's setup
            atm_t.TinyMPCFleet.setup(
                z, np.zeros((2, 3, 1)), np.ones((2, 3)), np.ones((2, 1)),
                1.0, 5, tier="hstream", device=DEV, mesh=object())
        return
    with pytest.raises(ValueError, match="multiple of check_termination"
                       if name == "stream_cascade_solve"
                       else "segment_growth"):
        getattr(ct_mod, name)(
            torch.zeros((2, 3)), None, None, segment_iters=12,
            check_termination=5 if name == "stream_cascade_solve" else 0,
            segment_growth=1.0 if name == "stream_cascade_solve" else 0.5)
