"""PyTorch port, scan tier: ``solve`` / ``solve_batched`` vs the JAX
package's ``admm.solve`` / ``solve_batched`` on the same numpy inputs, and
the golden trajectories of the compiled C++ reference.

Bars: float64 atol 1e-10 and iteration counts exactly equal -- this pins the
semantics. float32 atol 1e-4, the repo's own parity bar between float32
tiers: both run the same schedule, but XLA and PyTorch order the float32
sums inside the small products differently, and up to 120 iterations of
this problem amplify one rounding (6e-8) to ~5e-5 (measured). The residual
fields are rho * max|a - b| of two such iterates (rho = 5), so their bar is
2 * rho * 1e-4. All bars are relative to the field's largest entry where
that exceeds 1 (the costate ``p`` reaches 2e3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.models import (
    quadrotor_hovering_setup as hovering_j,
    quadrotor_tracking_setup as tracking_j,
)
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched as init_batched_j,
    solve_batched as solve_batched_j,
)
from accelerated_tinympc_tpu_torch.solver import (
    batch_stats, init_state_batched, solve_batched,
)

from golden_utils import load_traj_csv
from torch_parity_utils import (
    DEV, assert_fields_close, cache_to_torch, perturbed_x0, problem_to_torch,
    settings_to_torch, state_to_torch, to_np,
)

F32_ATOL, F64_ATOL = 1e-4, 1e-10
RESIDUALS = ("primal_residual_state", "primal_residual_input",
             "dual_residual_state", "dual_residual_input")
U_TOL = 1e-4  # control-parity bound against the reference trajectories

_solve_j = jax.jit(atm_j.solve)
_solve_batched_j = jax.jit(solve_batched_j)


def _pair(x64: bool):
    """Hovering problem in both packages at one precision."""
    jdt, tdt = (jnp.float64, torch.float64) if x64 else (jnp.float32, torch.float32)
    pj, cj, x0 = hovering_j(dtype=jdt)
    return pj, cj, problem_to_torch(pj, tdt), cache_to_torch(cj, tdt), x0, jdt, tdt


def _assert_state_close(got, want, x64):
    from torch_parity_utils import fields_of

    atol = F64_ATOL if x64 else F32_ATOL
    names = [k for k in fields_of(want) if k not in RESIDUALS]
    assert_fields_close(got, want, atol=atol, scaled=True, names=names)
    assert_fields_close(got, want, atol=10 * atol, names=RESIDUALS)


CASES = {
    "fixed30": dict(max_iter=30, check_termination=0),
    "adaptive": dict(max_iter=120, check_termination=1,
                     abs_pri_tol=0.05, abs_dua_tol=0.05),
    "check5": dict(max_iter=120, check_termination=5,
                   abs_pri_tol=0.05, abs_dua_tol=0.05),
    "alpha1.6": dict(max_iter=60, check_termination=1, alpha=1.6,
                     abs_pri_tol=0.05, abs_dua_tol=0.05),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_solve_matches_jax(case, x64):
    with jax.enable_x64(x64):
        pj, cj, pt, ct, x0, jdt, tdt = _pair(x64)
        sj = atm_j.Settings(**CASES[case])
        st0 = atm_j.set_x0(atm_j.init_state(12, 4, 10, jdt), jnp.asarray(x0, jdt))
        want = _solve_j(st0, pj, cj, sj)
        got = atm_t.solve(state_to_torch(st0, tdt), pt, ct,
                          settings_to_torch(sj))
        _assert_state_close(got, want, x64)
        assert int(got.iter) == int(want.iter)
        assert int(got.status) == int(want.status)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_solve_batched_matches_jax(case, x64):
    B = 5
    with jax.enable_x64(x64):
        pj, cj, pt, ct, x0, jdt, tdt = _pair(x64)
        sj = atm_j.Settings(**CASES[case])
        x0s = perturbed_x0(x0, B, seed=3)
        st0 = init_batched_j(B, 12, 4, 10, jdt)
        st0 = st0.replace(x=st0.x.at[:, 0, :].set(jnp.asarray(x0s, jdt)))
        want = _solve_batched_j(st0, pj, cj, sj)
        tset = settings_to_torch(sj)
        got = solve_batched(state_to_torch(st0, tdt), pt, ct, tset)
        _assert_state_close(got, want, x64)
        if x64:
            np.testing.assert_array_equal(to_np(got.iter), to_np(want.iter))
        if sj.check_termination and case != "alpha1.6":
            assert len(set(to_np(got.iter).tolist())) > 1  # exits diverge
        stats = batch_stats(got, tset)
        assert float(stats["iterations_mean"]) == pytest.approx(
            float(np.mean(to_np(want.iter))))


def test_batched_instance_equals_single_solve():
    """The per-instance freeze keeps each instance on its standalone path."""
    _, _, pt, ct, x0, _, tdt = _pair(True)
    settings = atm_t.Settings(**CASES["adaptive"])
    x0s = perturbed_x0(x0, 3, seed=9)
    st = init_state_batched(3, 12, 4, 10, tdt, DEV)
    got = solve_batched(atm_t.set_x0(st, x0s), pt, ct, settings)
    for i in range(3):
        one = atm_t.solve(
            atm_t.set_x0(atm_t.init_state(12, 4, 10, tdt, DEV), x0s[i]),
            pt, ct, settings)
        assert int(one.iter) == int(got.iter[i])
        np.testing.assert_allclose(to_np(one.u), to_np(got.u[i]), atol=1e-12)
        np.testing.assert_allclose(to_np(one.d), to_np(got.d[i]), atol=1e-12)


def test_batched_per_instance_problem_raises():
    _, _, pt, ct, _, _, tdt = _pair(False)
    st = init_state_batched(2, 12, 4, 10, tdt, DEV)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_batched(st, pt, ct, atm_t.Settings(), problem_axes=0)


def _mpc_loop(problem, cache, settings, x0, steps, Xref_total=None):
    """The reference receding-horizon loop on the port's scan tier."""
    from accelerated_tinympc_tpu_torch.api import mpc_rollout

    _, _, trace = mpc_rollout(problem, cache, settings, x0, steps,
                              Xref_total=Xref_total)
    return to_np(trace.x), to_np(trace.u), to_np(trace.iters)


def test_golden_hovering_fixed50():
    p, c, x0 = atm_t.models.quadrotor_hovering_setup(device=DEV)
    s = atm_t.Settings(max_iter=50, check_termination=0)
    xs, us, _ = _mpc_loop(p, c, s, x0, 70)
    want = load_traj_csv("hovering_fixed50", 12, 4)
    np.testing.assert_allclose(us, want["u0"], rtol=0, atol=U_TOL)
    np.testing.assert_allclose(xs, want["x0"], rtol=0, atol=1e-3)


def test_golden_hovering_adaptive_f64_exact():
    p, c, x0 = atm_t.models.quadrotor_hovering_setup(
        dtype=torch.float64, device=DEV)
    s = atm_t.Settings(max_iter=100, check_termination=1)
    _, us, iters = _mpc_loop(p, c, s, x0, 70)
    want = load_traj_csv("hovering_adaptive", 12, 4)
    np.testing.assert_array_equal(iters, want["iters"])
    np.testing.assert_allclose(us, want["u0"], rtol=0, atol=1e-9)


def test_golden_tracking_adaptive_f64_exact():
    """First 120 ticks of the 290-tick tracking mission (time budget)."""
    T = 120
    p, c, x0, Xref_total = atm_t.models.quadrotor_tracking_setup(
        dtype=torch.float64, device=DEV)
    s = atm_t.Settings(max_iter=100, check_termination=1)
    _, us, iters = _mpc_loop(p, c, s, x0, T, Xref_total=Xref_total)
    want = load_traj_csv("tracking_adaptive", 12, 4)
    np.testing.assert_array_equal(iters, want["iters"][:T])
    np.testing.assert_allclose(us, want["u0"][:T], rtol=0, atol=1e-9)


def test_mpc_rollout_matches_jax_batched():
    from accelerated_tinympc_tpu.api import mpc_rollout as rollout_j
    from accelerated_tinympc_tpu_torch.api import mpc_rollout, tracking_error
    from accelerated_tinympc_tpu.api import tracking_error as tracking_error_j

    pj, cj, x0, Xref_total = tracking_j()
    pt, ct = problem_to_torch(pj), cache_to_torch(cj)
    sj = atm_j.Settings(max_iter=25, check_termination=0)
    x0s = perturbed_x0(x0, 3, seed=4, spread=0.02).astype(np.float32)
    T = 6
    _, xf_j, tr_j = jax.jit(lambda x: rollout_j(
        pj, cj, sj, x, T, Xref_total=jnp.asarray(Xref_total, jnp.float32),
        batched=True))(jnp.asarray(x0s))
    _, xf_t, tr_t = mpc_rollout(
        pt, ct, settings_to_torch(sj), torch.as_tensor(x0s), T,
        Xref_total=Xref_total, batched=True)
    np.testing.assert_allclose(to_np(xf_t), to_np(xf_j), atol=F32_ATOL)
    assert_fields_close(tr_t, tr_j, atol=F32_ATOL)
    np.testing.assert_allclose(
        to_np(tracking_error(tr_t, Xref_total)),
        to_np(tracking_error_j(tr_j, jnp.asarray(Xref_total, jnp.float32))),
        atol=F32_ATOL)
