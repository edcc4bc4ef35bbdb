"""PyTorch port, ``TinyMPC`` on its three tiers vs the JAX package's
``TinyMPC`` (``solve()`` stats, ``get_u``/``get_x``, ``rollout``), the
setters, and every "raises for now" case.

Bars: float32 results atol 1e-4 (the repo's parity bar between float32
tiers); fixed iteration counts where values are compared, so no early exit
sits on a knife edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t

from torch_parity_utils import (
    DEV, cache_to_torch, perturbed_x0, problem_to_torch, to_np,
)

ATOL = 1e-4
TIERS = ("scan", "condensed", "fused")


def _pair(tier, batch, settings_kw, x0s=None):
    pj, cj, x0 = atm_j.models.quadrotor_hovering_setup()
    mj = atm_j.TinyMPC.from_parts(
        pj, cj, settings=atm_j.Settings(**settings_kw), batch=batch,
        tier=tier, interpret=True)
    mt = atm_t.TinyMPC.from_parts(
        problem_to_torch(pj), cache_to_torch(cj),
        settings=atm_t.Settings(**settings_kw), batch=batch, tier=tier,
        device=DEV)
    if x0s is None:
        x0s = x0 if batch is None else perturbed_x0(x0, batch, seed=1, spread=0.05)
    x0s = np.asarray(x0s, np.float32)
    mj.set_x0(x0s)
    mt.set_x0(x0s)
    return mj, mt


@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batch3"])
@pytest.mark.parametrize("tier", TIERS)
def test_solve_matches_jax(tier, batch):
    mj, mt = _pair(tier, batch, dict(max_iter=25, check_termination=0))
    sj, st = mj.solve(), mt.solve()
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(np.asarray(st[k], np.float64),
                                   np.asarray(sj[k], np.float64),
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(mt.get_u(), mj.get_u(), atol=ATOL)
    np.testing.assert_allclose(mt.get_x(), mj.get_x(), atol=2e-4)
    assert mt.get_u().shape == ((9, 4) if batch is None else (3, 9, 4))


@pytest.mark.parametrize("tier", TIERS)
def test_adaptive_solve_stats_match_jax(tier):
    kw = dict(max_iter=150, check_termination=1, abs_pri_tol=0.05,
              abs_dua_tol=0.05)
    mj, mt = _pair(tier, 4, kw)
    sj, st = mj.solve(), mt.solve()
    assert float(st["converged_fraction"]) == float(sj["converged_fraction"]) > 0
    assert abs(float(st["iterations_mean"]) - float(sj["iterations_mean"])) <= 1.0
    # a second, warm solve after a dual reset
    mj.reset_duals(); mt.reset_duals()
    sj, st = mj.solve(), mt.solve()
    assert abs(float(st["iterations_mean"]) - float(sj["iterations_mean"])) <= 1.0


@pytest.mark.parametrize("tier", TIERS)
def test_rollout_matches_jax(tier):
    mj, mt = _pair(tier, 2, dict(max_iter=20, check_termination=0))
    xf_j, us_j = mj.rollout(4)
    xf_t, us_t = mt.rollout(4)
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j), atol=ATOL)
    np.testing.assert_allclose(to_np(xf_t), np.asarray(xf_j), atol=ATOL)
    # the solver's state advanced: a continuation composes
    xf_j, us_j = mj.rollout(2)
    xf_t, us_t = mt.rollout(2)
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j), atol=ATOL)


@pytest.mark.parametrize("in_kernel", [False, True])
def test_fused_tracking_rollout_single_matches_jax(in_kernel):
    pj, cj, x0, Xref_total = atm_j.models.quadrotor_tracking_setup()
    kw = dict(max_iter=20, check_termination=0)
    mj = atm_j.TinyMPC.from_parts(pj, cj, settings=atm_j.Settings(**kw),
                                  tier="fused", interpret=True)
    mt = atm_t.TinyMPC.from_parts(
        problem_to_torch(pj), cache_to_torch(cj),
        settings=atm_t.Settings(**kw), tier="fused", device=DEV)
    mj.set_x0(x0); mt.set_x0(x0)
    xf_j, us_j = mj.rollout(5, Xref_total=jnp.asarray(Xref_total, jnp.float32),
                            in_kernel=in_kernel)
    xf_t, us_t = mt.rollout(5, Xref_total=Xref_total, in_kernel=in_kernel)
    assert us_t.shape == (5, 4) and xf_t.shape == (12,)
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j), atol=ATOL)
    np.testing.assert_allclose(to_np(xf_t), np.asarray(xf_j), atol=ATOL)


def test_in_kernel_needs_fused_tier():
    _, mt = _pair("scan", None, dict(max_iter=5, check_termination=0))
    with pytest.raises(ValueError, match="requires tier='fused'"):
        mt.rollout(2, in_kernel=True)


@pytest.mark.parametrize("tier", TIERS)
def test_setup_and_setters_match_jax(tier):
    """``setup`` (own Riccati precompute), ``set_xref``, ``set_bounds``: a
    random plant without state bounds, then bounds switched on."""
    pj, rho = atm_j.models.random_lti_problem(4, 5, 2, 6)
    A, Bm, Q, R = (np.asarray(a) for a in (pj.A, pj.B, pj.Q, pj.R))
    kw = dict(u_min=-0.4, u_max=0.4, batch=3, tier=tier)
    skw = dict(max_iter=30, check_termination=0)
    mj = atm_j.TinyMPC.setup(A, Bm, Q, R, rho, 6,
                             settings=atm_j.Settings(**skw), interpret=True, **kw)
    mt = atm_t.TinyMPC.setup(A, Bm, Q, R, rho, 6,
                             settings=atm_t.Settings(**skw), device=DEV, **kw)
    assert mt.settings.en_input_bound and not mt.settings.en_state_bound
    rng = np.random.default_rng(0)
    x0s = rng.standard_normal((3, 5)).astype(np.float32)
    Xref = (0.2 * rng.standard_normal((6, 5))).astype(np.float32)
    for m in (mj, mt):
        m.set_x0(x0s)
        m.set_xref(Xref)
        m.solve()
    np.testing.assert_allclose(mt.get_u(), mj.get_u(), atol=ATOL)
    for m in (mj, mt):
        m.set_bounds(x_min=-0.5, x_max=0.5)
        m.reset_duals()
        m.solve()
    assert mt.settings.en_state_bound
    np.testing.assert_allclose(mt.get_u(), mj.get_u(), atol=ATOL)
    np.testing.assert_allclose(mt.get_x(), mj.get_x(), atol=2e-4)


def test_getters_before_first_solve():
    _, mt = _pair("fused", 2, dict(max_iter=5, check_termination=0))
    assert mt.get_u().shape == (2, 9, 4) and not mt.get_u().any()
    assert mt.get_x().shape == (2, 10, 12)


RAISES = {
    "tier_block": dict(tier="block"),
    "cones": dict(cones=object()),
    "cone_mu": dict(tier="fused", batch=2, cone_mu=np.zeros((1, 2))),
    "cone_shift_x": dict(tier="fused", batch=2, cone_shift_x=np.zeros((1, 2))),
    "compaction": dict(tier="fused", batch=2, compaction_segment=10),
    "bf16x3": dict(tier="fused", algo="bf16x3"),
    "polish": dict(tier="fused", polish=8),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_raises_for_now(case):
    p, c, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        atm_t.TinyMPC.from_parts(p, c, device=DEV, **RAISES[case])


def test_other_raises():
    p, c, _ = atm_t.models.quadrotor_hovering_setup(device=DEV)
    with pytest.raises(ValueError, match="tier must be one of"):
        atm_t.TinyMPC.from_parts(p, c, tier="warp", device=DEV)
    with pytest.raises(ValueError, match="unknown algo"):
        atm_t.TinyMPC.from_parts(p, c, algo="fp8", device=DEV)
    mt = atm_t.TinyMPC.from_parts(p, c, device=DEV)
    with pytest.raises(NotImplementedError, match="slice 7"):
        mt.solve_adaptive_rho()
    with pytest.raises(NotImplementedError, match="slice 6"):
        atm_t.TinyMPC.setup(np.eye(2), np.ones((2, 1)), np.ones(2), np.ones(1),
                            1.0, 4, cones=object(), device=DEV)


def test_public_names_match_jax_package():
    """What exists in the port carries the JAX package's public names."""
    for name in ("SOLVED", "UNSOLVED", "Cache", "Problem", "Settings", "State",
                 "init_state", "reset_duals", "set_x0", "CondensedOperators",
                 "condensed_operators", "riccati_cache", "admm", "solve",
                 "models", "api", "ops", "TinyMPC", "mpc_rollout"):
        assert hasattr(atm_j, name) and hasattr(atm_t, name), name
    for name in ("FusedCarry", "FusedResult", "PaddedProblem", "fused_solve",
                 "pad_problem", "unpad_controls", "unpad_states", "RolloutOps",
                 "RolloutResult", "fused_rollout", "rollout_const_seq",
                 "rollout_ops"):
        assert hasattr(atm_j.ops, name) and hasattr(atm_t.ops, name), name
    for name in ("TinyMPC", "MPCTrace", "default_plant", "fused_mpc_rollout",
                 "mpc_rollout", "tracking_error"):
        assert hasattr(atm_j.api, name) and hasattr(atm_t.api, name), name
