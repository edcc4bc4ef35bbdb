"""PyTorch port, condensed tier: ``solve_condensed`` vs the JAX package's and
vs the port's own scan tier. Bars as in test_torch_admm.py: float64 atol
1e-10 with iteration counts exactly equal; float32 atol 1e-4 (residual
fields 2 * rho * 1e-4), relative to the field's largest entry above 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup as hovering_j
from accelerated_tinympc_tpu.precompute import (
    condensed_operators as condensed_operators_j,
)
from accelerated_tinympc_tpu.solver import condensed as cond_j
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched as init_batched_j,
)
from accelerated_tinympc_tpu_torch.solver import (
    condensed as cond_t, init_state_batched, solve_batched,
)

from torch_parity_utils import (
    DEV, assert_fields_close, cache_to_torch, fields_of, perturbed_x0,
    problem_to_torch, settings_to_torch, state_to_torch, to_np,
)

B = 4
RESIDUALS = ("primal_residual_state", "primal_residual_input",
             "dual_residual_state", "dual_residual_input")
CASES = {
    "fixed25": dict(max_iter=25, check_termination=0),
    "adaptive": dict(max_iter=120, check_termination=1,
                     abs_pri_tol=0.05, abs_dua_tol=0.05),
    "alpha1.6": dict(max_iter=60, check_termination=2, alpha=1.6,
                     abs_pri_tol=0.05, abs_dua_tol=0.05),
}

_solve_condensed_j = jax.jit(cond_j.solve_condensed, static_argnums=(4,))


def _close(got, want, atol):
    names = [k for k in fields_of(want) if k not in RESIDUALS]
    assert_fields_close(got, want, atol=atol, scaled=True, names=names)
    assert_fields_close(got, want, atol=10 * atol, names=RESIDUALS)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_solve_condensed_matches_jax(case, x64):
    jdt, tdt = (jnp.float64, torch.float64) if x64 else (jnp.float32, torch.float32)
    with jax.enable_x64(x64):
        pj, cj, x0 = hovering_j(dtype=jdt)
        pt, ct = problem_to_torch(pj, tdt), cache_to_torch(cj, tdt)
        sj = atm_j.Settings(**CASES[case])
        x0s = perturbed_x0(x0, B, seed=5)
        st0 = init_batched_j(B, 12, 4, 10, jdt)
        st0 = st0.replace(x=st0.x.at[:, 0, :].set(jnp.asarray(x0s, jdt)))
        ops_j = condensed_operators_j(
            cj, np.asarray(pj.A), np.asarray(pj.B), 10,
            dtype=np.float64 if x64 else np.float32)
        want = _solve_condensed_j(
            cond_j.flat_from_state(st0, 12, 4),
            cond_j.flatten_problem(pj, cj), ops_j, sj, 12)
        ops_t = atm_t.condensed_operators(ct, pt.A, pt.B, 10, dtype=tdt,
                                          device=DEV)
        got = cond_t.solve_condensed(
            cond_t.flat_from_state(state_to_torch(st0, tdt), 12, 4),
            cond_t.flatten_problem(pt, ct), ops_t, settings_to_torch(sj), 12)
        _close(got, want, 1e-10 if x64 else 1e-4)
        if x64:
            np.testing.assert_array_equal(to_np(got.iter), to_np(want.iter))
        # and back in the time-major layout
        _close(cond_t.state_from_flat(got, 12, 4, 10),
               cond_j.state_from_flat(want, 12, 4, 10),
               1e-10 if x64 else 1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_condensed_equals_scan_tier_f64(case):
    """Same schedule as the port's own ground truth, to rounding."""
    tdt = torch.float64
    p, c, x0 = atm_t.models.quadrotor_hovering_setup(dtype=tdt, device=DEV)
    settings = atm_t.Settings(**CASES[case])
    st = atm_t.set_x0(init_state_batched(B, 12, 4, 10, tdt, DEV),
                      perturbed_x0(x0, B, seed=6))
    want = solve_batched(st, p, c, settings)
    ops = atm_t.condensed_operators(c, p.A, p.B, 10, dtype=tdt, device=DEV)
    got = cond_t.state_from_flat(
        cond_t.solve_condensed(
            cond_t.flat_from_state(st, 12, 4), cond_t.flatten_problem(p, c),
            ops, settings, 12),
        12, 4, 10)
    np.testing.assert_array_equal(to_np(got.iter), to_np(want.iter))
    np.testing.assert_array_equal(to_np(got.status), to_np(want.status))
    names = ("x", "u", "d", "v", "z", "vnew", "znew", "g", "y")
    for k in names:
        a, b = to_np(getattr(got, k)), to_np(getattr(want, k))
        if k == "x":  # condensed X keeps x0 in knot 0 as well
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=k)


def test_flat_layout_roundtrip():
    rng = np.random.default_rng(0)
    st = init_state_batched(3, 5, 2, 4, torch.float64, DEV)
    st = st.replace(**{
        k: torch.as_tensor(rng.standard_normal(tuple(v.shape)))
        for k, v in st.tensors().items() if v.is_floating_point()})
    back = cond_t.state_from_flat(cond_t.flat_from_state(st, 5, 2), 5, 2, 4)
    assert_fields_close(back, st, atol=0.0)
    flat = cond_t.init_flat_state(3, 5, 2, 4, device=DEV)
    assert flat.X.shape == (3, 20) and flat.U.shape == (3, 6)


def test_condensed_cones_raise():
    p, c, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    ops = atm_t.condensed_operators(c, p.A, p.B, 10, device=DEV)
    s = cond_t.init_flat_state(2, 12, 4, 10, device=DEV)
    fp = cond_t.flatten_problem(p, c)
    with pytest.raises(NotImplementedError, match="slice 6"):
        cond_t.solve_condensed(s, fp, ops, atm_t.Settings(), 12, cones=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        cond_t.condensed_iteration(s, fp, ops, atm_t.Settings(), 12,
                                   cones=object())
