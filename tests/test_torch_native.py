"""The port's ``NativeSolver`` (``accelerated_tinympc_tpu_torch.native``),
the ctypes binding of ``native/src/tinympc_native.cpp`` built into
``build/native/``, held to the JAX package's binding of the same source and
to the port's scan tier at ``tests/test_native.py``'s bars. Nothing under
``native/`` may be written."""

import pathlib

import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.native import NativeSolver as NativeJ
from accelerated_tinympc_tpu_torch import native as nat
from accelerated_tinympc_tpu_torch.models import cartpole
from accelerated_tinympc_tpu_torch.native import NativeSolver

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
DEV = "cpu"


def _snapshot() -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(NATIVE_DIR.rglob("*"))}


@pytest.fixture(scope="module", autouse=True)
def native_dir_untouched():
    """The binding builds into ``build/native/`` and writes nothing under
    ``native/`` (the JAX package's ``_load`` runs ``make -C native``, so
    the JAX binding is loaded before the snapshot)."""
    from accelerated_tinympc_tpu.native import get_lib

    get_lib()
    before = _snapshot()
    yield
    assert _snapshot() == before


@pytest.fixture(scope="module")
def quad():
    problem, cache, x0 = atm_t.models.quadrotor_hovering_setup(device=DEV)
    args = tuple(np.asarray(getattr(problem, k), np.float64)
                 for k in ("A", "B", "Q", "R"))
    return problem, cache, np.asarray(x0, np.float64), args


def _make(cls, quad, **kw):
    problem, cache, _x0, args = quad
    ns = cls(*args, rho=float(cache.rho), horizon=10, **kw)
    ns.set_bounds(u_min=-0.5, u_max=0.5, x_min=-5.0, x_max=5.0)
    ns.set_xref(np.asarray(problem.Xref, np.float64))
    return ns


def _scan(problem, cache, x0, **sets):
    st = atm_t.set_x0(atm_t.init_state(problem.nx, problem.nu,
                                       problem.horizon, device=DEV),
                      torch.as_tensor(x0, dtype=torch.float32))
    return atm_t.solve(st, problem, cache, atm_t.Settings(**sets))


def test_builds_into_build_dir_with_jax_bindings_surface():
    """The library lands in ``build/native/`` under a hash of the source
    and flags; the class carries the JAX binding's method set."""
    so = nat.build_native_library()
    assert so.parent == nat.build_dir() and so.name.startswith(
        "libtinympc_native_") and so.exists()
    public = lambda c: {k for k in vars(c) if not k.startswith("_")}
    assert public(NativeSolver) == public(NativeJ)


def test_native_precompute_matches(quad):
    """The C++ Riccati fixed point against the JAX binding's (the same
    source) and the port's float64 precompute (``test_native.py``'s bars)."""
    problem, cache, _x0, args = quad
    got = _make(NativeSolver, quad, max_iter=30,
                check_termination=0).get_cache()
    want = _make(NativeJ, quad, max_iter=30, check_termination=0).get_cache()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    ours = atm_t.riccati_cache(*args, float(cache.rho), dtype=torch.float64,
                               device=DEV)
    np.testing.assert_allclose(got["Kinf"], ours.Kinf.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["Pinf"], ours.Pinf.numpy(), rtol=1e-9,
                               atol=1e-7)


def test_native_solve_and_batch_match(quad):
    """A fixed 30-iteration solve against the port's scan tier (2e-4) and
    the JAX binding; a batch of four is cold-start independent."""
    problem, cache, x0, _args = quad
    ns = _make(NativeSolver, quad, max_iter=30, check_termination=0)
    ns.set_x0(x0)
    info = ns.solve()
    assert info["iterations"] == 30
    out = _scan(problem, cache, x0, max_iter=30, check_termination=0)
    np.testing.assert_allclose(ns.get_u(), out.u.double().numpy(), rtol=0,
                               atol=2e-4)
    nj = _make(NativeJ, quad, max_iter=30, check_termination=0)
    nj.set_x0(x0)
    nj.solve()
    np.testing.assert_allclose(ns.get_u(), nj.get_u(), rtol=0, atol=1e-12)
    x0s = x0[None] + 0.05 * np.random.default_rng(0).standard_normal((4, 12))
    u, iters, _status = ns.solve_batch(x0s)
    assert u.shape == (4, 9, 4) and np.all(iters == 30)
    cold = _make(NativeSolver, quad, max_iter=30, check_termination=0)
    cold.set_x0(x0s[0])
    cold.solve()
    np.testing.assert_allclose(u[0], cold.get_u(), rtol=0, atol=1e-12)


def test_native_adaptive_and_warm_start(quad):
    """The 70-tick receding-horizon hover (reset duals, carry slacks)
    reaches the setpoint."""
    problem, _cache, x0, (A, B, _Q, _R) = quad
    ns = _make(NativeSolver, quad, max_iter=100, check_termination=1)
    x = x0.copy()
    for _ in range(70):
        ns.reset_duals()
        ns.set_x0(x)
        ns.solve()
        x = A @ x + B @ ns.get_u()[0]
    assert np.linalg.norm(x - problem.Xref[0].double().numpy()) < 0.01


def test_cartpole_native():
    """The cartpole against the port's scan tier at 1e-4."""
    ns = NativeSolver(cartpole.A, cartpole.B, cartpole.Q_DIAG,
                      cartpole.R_DIAG, rho=cartpole.RHO, horizon=10,
                      max_iter=25, check_termination=0)
    ns.set_bounds(u_min=-5.0, u_max=5.0, x_min=-5.0, x_max=5.0)
    x0 = np.array([0.3, 0.0, 0.1, 0.0])
    ns.set_x0(x0)
    ns.solve()
    problem = cartpole.cartpole_problem(10, device=DEV)
    cache = atm_t.riccati_cache(cartpole.A, cartpole.B, cartpole.Q_DIAG,
                                cartpole.R_DIAG, cartpole.RHO, device=DEV)
    out = _scan(problem, cache, x0, max_iter=25, check_termination=0)
    np.testing.assert_allclose(ns.get_u(), out.u.double().numpy(), rtol=0,
                               atol=1e-4)


def test_native_cones_match_engine():
    """A thrust cone: the float64 host solver against the port's coned scan
    solve at 5e-3 (``test_native.py``'s bar) and the JAX binding."""
    from accelerated_tinympc_tpu.solver.cones import (
        Cone as ConeJ, ConeSet as ConeSetJ,
    )
    from accelerated_tinympc_tpu_torch.models._problem import make_problem
    from accelerated_tinympc_tpu_torch.solver.admm import solve
    from accelerated_tinympc_tpu_torch.solver.cones import (
        Cone, ConeSet, cone_slack_update, cone_violation,
    )

    dt, N, I3 = 0.1, 15, np.eye(3)
    A = np.block([[I3, dt * I3], [0 * I3, I3]])
    B = np.vstack([0.5 * dt * dt * I3, dt * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    x0 = np.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5])
    us = []
    for cls, cone in ((NativeSolver, ConeSet(input_cones=(Cone(
            ball=(0, 1), axis=2, mu=1.0, shift=3.0),))),
                      (NativeJ, ConeSetJ(input_cones=(ConeJ(
                          ball=(0, 1), axis=2, mu=1.0, shift=3.0),)))):
        ns = cls(A, B, Q, R, rho=1.0, horizon=N, max_iter=400,
                 check_termination=1)
        ns.set_cones(cone)
        ns.set_x0(x0)
        assert ns.solve()["solved"]
        us.append(ns.get_u())
    np.testing.assert_allclose(us[0], us[1], rtol=0, atol=1e-12)
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0,
                                      shift=3.0),))
    problem = make_problem(A, B, Q, R, N, u_bound=1e17, x_bound=1e17,
                           device=DEV)
    cache = atm_t.riccati_cache(A, B, Q, R, 1.0, device=DEV)
    sets = atm_t.Settings(max_iter=400, check_termination=1,
                          en_input_bound=False, en_state_bound=False)
    st = atm_t.set_x0(atm_t.init_state(6, 3, N, device=DEV),
                      torch.as_tensor(x0, dtype=torch.float32))
    ref = solve(st, problem, cache, sets, project=cone_slack_update(cones))
    assert int(ref.status) == atm_t.SOLVED
    np.testing.assert_allclose(us[0], ref.u.double().numpy(), rtol=0,
                               atol=5e-3)
    assert float(cone_violation(torch.as_tensor(us[0]), cones.input_cones[0])
                 ) < 5e-3


def test_native_adaptive_rho_single_and_batch():
    """Rho adaptation rescues a 4-orders mis-scaled penalty, single and
    batched, with the JAX binding's outcomes."""
    p, _rho = atm_t.models.random_lti_problem(
        seed=3, nx=8, nu=3, horizon=15, bound=5.0, q_scale=100.0,
        r_scale=0.1, device=DEV)
    args = tuple(getattr(p, k).numpy() for k in ("A", "B", "Q", "R"))
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(8)
    x0s = np.random.default_rng(0).standard_normal((6, 8))
    outs = []
    for cls in (NativeSolver, NativeJ):
        ns = cls(*args, rho=1e-2, horizon=15, max_iter=1500,
                 check_termination=1, abs_pri_tol=2e-3, abs_dua_tol=2e-3)
        ns.set_bounds(u_min=np.full((14, 3), -0.3),
                      u_max=np.full((14, 3), 0.3))
        ns.set_x0(x0)
        assert not ns.solve()["solved"], "premise: fixed bad rho fails"
        ns.reset_duals()
        ns.set_x0(x0)
        info = ns.solve_adaptive_rho(chunk=25, max_total_iter=1500)
        assert info["solved"] and info["rho"] != 1e-2
        assert info["iterations"] <= 800
        outs.append((info, ns.solve_batch_adaptive(x0s,
                                                   max_total_iter=4000)))
    (info_t, (u, rho, iters, solved)), (info_j, batch_j) = outs
    assert info_t == info_j
    assert solved.all() and (rho != 1e-2).all() and u.shape == (6, 14, 3)
    for a, b in zip((u, rho, iters, solved), batch_j):
        np.testing.assert_array_equal(a, b)
