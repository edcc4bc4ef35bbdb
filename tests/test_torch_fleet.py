"""PyTorch port, fleet surface (``api/fleet.py``, ``api/mpc.py::
fleet_mpc_rollout``, the hetero and scan adaptive-rho loops) against the JAX
package's ``TinyMPCFleet`` on the scan and instance-ops tiers, which run no
Pallas interpreter. Caches come from each package's float64 host path
(``host_precompute=True``) where two fleets are compared, so both solve the
same problem.

Bars: iteration counts equal, controls within 1e-4 (float32, two
implementations); adaptive rho: the same decisions (solved set, rounds per
instance), rho within 5 % (residual ratios of float32 iterates) and controls
at the adaptation tolerance's scale, as the JAX package's own tests hold
them."""

import io
import contextlib
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.models import random_lti_problem
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch.api import fleet_mpc_rollout

from torch_parity_utils import DEV, to_np

B, NX, NU, N = 6, 5, 2, 7
ROOT = pathlib.Path(__file__).resolve().parents[1]
SETS = dict(max_iter=80, check_termination=2, abs_pri_tol=5e-3,
            abs_dua_tol=5e-3)


@pytest.fixture(scope="module")
def plants():
    As, Bs, Qs, Rs = [], [], [], []
    for seed in range(B):
        p, _rho = random_lti_problem(seed=seed, nx=NX, nu=NU, horizon=N)
        As.append(np.asarray(p.A))
        Bs.append(np.asarray(p.B))
        Qs.append(np.asarray(p.Q))
        Rs.append(np.asarray(p.R))
    x0s = (0.4 * np.random.default_rng(1).standard_normal((B, NX))).astype(
        np.float32)
    return np.stack(As), np.stack(Bs), np.stack(Qs), np.stack(Rs), x0s


def _pair(plants, tier, jtier=None, settings=SETS, rho=1.0, **kw):
    A, Bm, Q, R, x0s = plants
    fj = atm_j.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=rho, horizon=N, settings=atm_j.Settings(**settings),
        tier=jtier or tier, host_precompute=True, **kw)
    ft = atm_t.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=rho, horizon=N, settings=atm_t.Settings(**settings),
        tier=tier, host_precompute=True, device=DEV, **kw)
    fj.set_x0(x0s)
    ft.set_x0(x0s)
    return fj, ft


@pytest.mark.parametrize("tier", ["scan", "instance_ops", "hetero"])
def test_tiers_match_jax(plants, tier):
    """Each port tier against JAX (the hetero tier against JAX's
    instance-ops tier: the same per-instance semantics)."""
    fj, ft = _pair(plants, tier, "instance_ops" if tier == "hetero" else None,
                   u_min=-0.5, u_max=0.5)
    ij, it = fj.solve(), ft.solve()
    np.testing.assert_array_equal(it["iterations"], ij["iterations"])
    np.testing.assert_array_equal(it["solved"], ij["solved"])
    np.testing.assert_allclose(to_np(ft.get_u()), to_np(fj.get_u()),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(ft.get_x()), to_np(fj.get_x()),
                               atol=1e-4)
    # the re-solve protocol: duals zeroed, warm slacks kept
    fj.reset_duals()
    ft.reset_duals()
    np.testing.assert_array_equal(ft.solve()["iterations"],
                                  fj.solve()["iterations"])
    np.testing.assert_allclose(to_np(ft.get_u()), to_np(fj.get_u()),
                               atol=1e-4)


def test_fleet_mpc_rollout_matches_jax_scan_ticks(plants):
    """Three adaptive ticks of ``fleet_mpc_rollout`` against a JAX
    ``TinyMPCFleet(tier="scan")`` tick loop, and against the port's own
    fleet tick loop on the hetero tier."""
    A, Bm, Q, R, x0s = plants
    sets = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3)
    fj, ft = _pair(plants, "hetero", "scan", settings=sets, u_min=-0.5,
                   u_max=0.5)
    x, us_j = x0s.astype(np.float64), []
    xt, us_t = torch.as_tensor(x0s), []
    for _ in range(3):
        fj.set_x0(x.astype(np.float32))
        fj.solve()
        u0 = np.asarray(fj.get_u())[:, 0]
        us_j.append(u0)
        x = np.einsum("bij,bj->bi", A, x) + np.einsum("bij,bj->bi", Bm, u0)
        fj.reset_duals()
        ft.set_x0(xt)
        ft.reset_duals()
        ft.solve()
        u0t = ft.get_u()[:, 0]
        us_t.append(u0t)
        xt = (ft.problem.A @ xt[..., None])[..., 0] + (
            ft.problem.B @ u0t[..., None])[..., 0]
    xf, us, _carry = fleet_mpc_rollout(
        ft._hp, ft.problem, torch.as_tensor(x0s), 3,
        check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    assert us.shape == (3, B, NU)
    np.testing.assert_allclose(to_np(us), np.stack(us_j), atol=1e-4)
    assert torch.equal(us, torch.stack(us_t)) and torch.equal(xf, xt)


def test_setters_match_jax(plants):
    """set_bounds (shared scalar, per-instance time-uniform), set_xref
    (per instance) and the errors of the surface, against JAX's scan tier."""
    fj, ft = _pair(plants, "scan")
    with pytest.raises(RuntimeError, match="no solve"):
        ft.get_u()
    with pytest.raises(ValueError, match="x0s shape"):
        ft.set_x0(np.zeros((B + 1, NX)))
    lim = np.linspace(0.3, 0.6, B)[:, None] * np.ones((B, NU))
    xref = 0.05 * np.random.default_rng(2).standard_normal((B, N, NX))
    for f in (fj, ft):
        f.set_bounds(u_min=-lim, u_max=lim)
        f.set_bounds(x_min=-3.0, x_max=3.0)
        f.set_xref(xref.astype(np.float32))
    assert ft.settings.en_input_bound and ft.settings.en_state_bound
    np.testing.assert_allclose(to_np(ft.problem.u_max[:, 2]), lim, atol=1e-7)
    ij, it = fj.solve(), ft.solve()
    np.testing.assert_array_equal(it["iterations"], ij["iterations"])
    np.testing.assert_allclose(to_np(ft.get_u()), to_np(fj.get_u()),
                               atol=1e-4)
    # the hetero tier with the same updates: the same controls
    fh = atm_t.TinyMPCFleet.setup(*plants[:4], rho=1.0, horizon=N,
                                  settings=atm_t.Settings(**SETS),
                                  host_precompute=True, device=DEV)
    fh.set_x0(plants[4])
    fh.set_bounds(u_min=-lim, u_max=lim, x_min=-3.0, x_max=3.0)
    fh.set_xref(xref)
    fh.solve()
    np.testing.assert_allclose(to_np(fh.get_u()), to_np(fj.get_u()),
                               atol=1e-4)


def test_set_plants_falls_back_where_newton_diverges(plants):
    """Drift every plant a little and destabilise instance 2's old gain:
    Newton refreshes the rest, instance 2 falls back to the warm fixed
    point, and the caches and controls match a cold setup of the new
    plants. Default setup polishes the device caches in float64 to the true
    fixed point, which the host path's truncated fixed point (stopping at
    max|dK| < 1e-5) approximates to a few 1e-3 on these slow plants."""
    A, Bm, Q, R, x0s = plants
    fleet = atm_t.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                                     settings=atm_t.Settings(**SETS),
                                     u_min=-0.5, u_max=0.5, device=DEV)
    host = atm_t.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                                    settings=atm_t.Settings(**SETS),
                                    host_precompute=True, device=DEV)
    for k, v in host.cache.tensors().items():   # polish=True by default
        w = getattr(fleet.cache, k)
        assert float((w - v).abs().max()) <= 5e-3 * max(1.0, float(
            v.abs().max())), k
    rng = np.random.default_rng(11)
    A2 = (A + 0.01 * rng.standard_normal(A.shape)).astype(np.float32)
    A2[2] = A2[2] + 0.1 * np.eye(NX, dtype=np.float32)
    fleet.set_plants(A=A2, refresh="newton")
    assert fleet.fallback_count == 1
    cold = atm_t.TinyMPCFleet.setup(A2, Bm, Q, R, rho=1.0, horizon=N,
                                    settings=atm_t.Settings(**SETS),
                                    u_min=-0.5, u_max=0.5, polish=False,
                                    device=DEV)
    for k in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        g, w = getattr(fleet.cache, k), getattr(cold.cache, k)
        assert bool(torch.isfinite(g).all()), k
        assert float((g - w).abs().max() / (w.abs().max() + 1.0)) < 2e-3, k
    for f in (fleet, cold):
        f.set_x0(x0s)
        f.solve()
    np.testing.assert_allclose(to_np(fleet.get_u()), to_np(cold.get_u()),
                               atol=1e-3)
    fleet.set_plants(Q=Q * 2.0, refresh="kernel")
    assert fleet.fallback_count == 0
    with pytest.raises(ValueError, match="refresh"):
        fleet.set_plants(A=A2, refresh="vmap")


RHO0 = np.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], np.float32)
ADAPT_SETS = dict(abs_pri_tol=0.02, abs_dua_tol=0.02, check_termination=1)


@pytest.mark.parametrize("engine,jengine,jtier", [
    ("hetero", "einsum", "instance_ops"), ("scan", "scan", "scan")])
def test_adaptive_rho_engines_match_jax(plants, engine, jengine, jtier):
    """Mis-scaled rho (a third each at 1, 1e-3, 1e3): the hetero engine
    against JAX's einsum engine, the scan engine against JAX's scan
    engine."""
    kw = dict(chunk=25, max_rounds=40)
    fj, ft = _pair(plants, "hetero" if engine == "hetero" else "scan",
                   jtier, settings=ADAPT_SETS, rho=RHO0)
    rj = fj.solve_adaptive_rho(engine=jengine, **kw)
    rt = ft.solve_adaptive_rho(engine=engine, **kw)
    assert rt["solved"].all()
    np.testing.assert_array_equal(rt["solved"], rj["solved"])
    np.testing.assert_allclose(rt["rho"][:2], [1.0, 1.0])
    np.testing.assert_allclose(rt["rho"], rj["rho"], rtol=5e-2)
    np.testing.assert_array_equal(np.ceil(rt["iterations"] / 25),
                                  np.ceil(rj["iterations"] / 25))
    np.testing.assert_allclose(to_np(ft.get_u()), to_np(fj.get_u()),
                               atol=5e-2)
    # the adapted caches are adopted: a re-solve runs at the adapted rho
    np.testing.assert_allclose(to_np(ft.cache.rho), rt["rho"])
    ft.solve()


def test_auto_engine_and_unported_paths(plants, monkeypatch):
    """``engine="auto"`` on CPU tensors is the einsum loop for the hetero
    tier (JAX: off the TPU); ``solve_adaptive_rho(mesh=)`` runs the sharded
    loop; ``setup(mesh=)`` (as in the JAX fleet) and alpha on the
    hetero/instance-ops tiers raise."""
    from accelerated_tinympc_tpu_torch.solver import batched_ops

    A, Bm, Q, R, x0s = plants
    calls = []
    real = batched_ops.solve_adaptive_rho_batched
    monkeypatch.setattr(batched_ops, "solve_adaptive_rho_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    f = atm_t.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                                 settings=atm_t.Settings(**ADAPT_SETS),
                                 polish=False, device=DEV)
    f.set_x0(x0s)
    f.solve_adaptive_rho(max_rounds=2)
    assert calls == [1]
    # the scan engine on the hetero tier keeps the hetero carry (the JAX
    # fleet installs the scan tier's State there: ROADMAP.md section 3)
    f.solve_adaptive_rho(engine="scan", max_rounds=1)
    assert isinstance(f._carry, atm_t.ops.HeteroCarry)
    f.solve()
    # mesh= on solve_adaptive_rho runs the sharded hetero loop (a world of
    # one here; two ranks in tests/test_torch_mesh.py); setup takes no
    # mesh=, as the JAX fleet's setup takes none
    from accelerated_tinympc_tpu_torch.parallel import make_batch_mesh

    out = f.solve_adaptive_rho(mesh=make_batch_mesh(device=DEV),
                               max_rounds=2)
    assert out["rho"].shape == (B,) and out["rounds"] <= 2
    assert isinstance(f._carry, atm_t.ops.HeteroCarry)
    f.solve()
    for tier in ("hetero", "hstream", "block"):
        atm_t.TinyMPCFleet.setup(A, Bm, Q, R, 1.0, N, tier=tier, device=DEV)
        with pytest.raises(TypeError, match="mesh"):
            atm_t.TinyMPCFleet.setup(A, Bm, Q, R, 1.0, N, tier=tier,
                                     mesh=object(), device=DEV)
    for tier in ("hetero", "instance_ops"):
        g = atm_t.TinyMPCFleet.setup(
            A, Bm, Q, R, 1.0, N, tier=tier, polish=False, device=DEV,
            settings=atm_t.Settings(alpha=1.6))
        g.set_x0(x0s)
        with pytest.raises(ValueError, match="alpha"):
            g.solve()
    with pytest.raises(ValueError, match="cones="):
        atm_t.TinyMPCFleet.setup(A, Bm, Q, R, 1.0, N, cone_mu=np.ones((1, B)),
                                 device=DEV)


def test_torch_fleet_sweep_example_runs():
    """``examples/torch_fleet_sweep.py --fleet 16 --ticks 2 --cones --cpu``
    runs and prints its verdict."""
    argv = sys.argv
    out = io.StringIO()
    try:
        sys.argv = ["torch_fleet_sweep.py", "--fleet", "16", "--ticks", "2",
                    "--cones", "--compaction", "4", "--drift", "0.003",
                    "--cpu"]
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / "torch_fleet_sweep.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("tick ") for ln in lines) == 2
    assert lines[-1] in ("FLEET CONTAINED", "CHECK FAILED")
