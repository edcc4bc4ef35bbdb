"""PyTorch port, per-instance-operator tier and adaptive rho on the CPU:
``build_instance_ops``, ``solve_instance_ops`` (with cones and per-instance
cone arguments), ``solve_adaptive_rho_batched`` (``riccati="vmap"``),
``solve_adaptive_rho`` and the ``TinyMPC`` object with cones / compaction /
adaptive rho, against the JAX package on the same random plants.

Bars: float32 1e-4 relative to the field's largest entry; float64 1e-9 with
equal iteration counts, rounds and rho (the adaptation's stall and imbalance
tests are knife-edges, so exact schedules are held in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu.models import random_lti_problem as random_lti_j
from accelerated_tinympc_tpu.precompute import riccati_cache as riccati_cache_j
from accelerated_tinympc_tpu.solver import adaptive_rho as arj
from accelerated_tinympc_tpu.solver import batched_ops as boj
from accelerated_tinympc_tpu.solver import cones as cj
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.solver import adaptive_rho as art
from accelerated_tinympc_tpu_torch.solver import batched_ops as bot
from accelerated_tinympc_tpu_torch.solver import cones as ct

from torch_parity_utils import (
    DEV, LANDER_X0, assert_fields_close, fields_of, lander_pair,
    landing_parts, perturbed_x0, settings_to_torch, state_to_torch, to_np,
)

B = 6
NX, NU, N = 4, 2, 6
RHO0 = np.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3])


def _plants(dtype):
    """B distinct random plants, batch-leading, as numpy dicts: problem
    fields, float64-host caches, x0s."""
    probs, caches = [], []
    for seed in range(B):
        p, rho = random_lti_j(seed=seed, nx=NX, nu=NU, horizon=N)
        pf = {k: np.asarray(v, np.float64) for k, v in fields_of(p).items()}
        probs.append(pf)
        caches.append(fields_of(riccati_cache_j(
            pf["A"], pf["B"], pf["Q"], pf["R"], rho, dtype=np.float64)))
    stack = lambda ds: {k: np.stack([d[k] for d in ds]).astype(dtype)
                        for k in ds[0]}
    rng = np.random.default_rng(3)
    x0s = (rng.standard_normal((B, NX)) * 0.4).astype(dtype)
    return stack(probs), stack(caches), x0s


def _both(dtype):
    pf, cf, x0s = _plants(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pj = atm_j.Problem(**{k: jnp.asarray(v) for k, v in pf.items()})
    cache_j = atm_j.Cache(**{k: jnp.asarray(v) for k, v in cf.items()})
    pt = convert.problem_from_numpy(pf, dtype=tdt, device=DEV)
    cache_t = convert.cache_from_numpy(cf, dtype=tdt, device=DEV)
    return pj, cache_j, pt, cache_t, x0s


@pytest.fixture(scope="module")
def f32():
    return _both(np.float32)


def _ops_close(got, want, atol):
    assert_fields_close(got, want, atol=atol, scaled=True,
                        names=[k for k in want._fields
                               if "min" not in k and "max" not in k])
    for k in ("u_min", "u_max", "x_min", "x_max"):
        np.testing.assert_array_equal(to_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)))


def test_build_instance_ops_matches_jax(f32):
    pj, cache_j, pt, cache_t, _x0s = f32
    want = jax.jit(boj.build_instance_ops)(pj, cache_j)
    got = bot.build_instance_ops(pt, cache_t)
    _ops_close(got, want, 1e-5)
    back = convert.instance_ops_from_numpy(fields_of(want), device=DEV)
    _ops_close(back, want, 0.0)


def test_build_from_plants_matches_jax(f32):
    pj, _cache_j, pt, _cache_t, _x0s = f32
    rho = np.full(B, 1.5, np.float32)
    want_ops, want_c = jax.jit(
        lambda *a: boj.build_instance_ops_from_plants(*a, riccati="vmap")
    )(pj.A, pj.B, pj.Q, pj.R, jnp.asarray(rho), pj)
    for riccati in ("vmap", "kernel", "auto"):   # CPU: "kernel" = its plain
        got_ops, got_c = bot.build_instance_ops_from_plants(
            pt.A, pt.B, pt.Q, pt.R, torch.as_tensor(rho), pt, riccati=riccati)
        _ops_close(got_ops, want_ops, 1e-4)
        assert_fields_close(got_c, want_c, atol=1e-4, scaled=True,
                            names=["Kinf", "Pinf", "Quu_inv", "AmBKt"])


SOLVE = {
    "fixed": dict(max_iter=30, check_termination=0),
    "adaptive": dict(max_iter=200, check_termination=1, abs_pri_tol=1e-3,
                     abs_dua_tol=1e-3),
    "adaptive_check5": dict(max_iter=200, check_termination=5,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3),
}


@pytest.mark.parametrize("mode", list(SOLVE))
def test_solve_instance_ops_float64_matches_jax(mode):
    with jax.enable_x64(True):
        pj, cache_j, pt, cache_t, x0s = _both(np.float64)
        sj = atm_j.Settings(**SOLVE[mode])
        ops_j = boj.build_instance_ops(pj, cache_j)
        want = jax.jit(lambda x, s: boj.solve_instance_ops(x, s, ops_j, sj))(
            jnp.asarray(x0s),
            boj.OpsState.zeros(B, N * NX, (N - 1) * NU, jnp.float64))
        got = bot.solve_instance_ops(
            torch.as_tensor(x0s),
            bot.OpsState.zeros(B, N * NX, (N - 1) * NU, torch.float64, DEV),
            bot.build_instance_ops(pt, cache_t), settings_to_torch(sj))
        assert_fields_close(got, want, atol=1e-9, scaled=True)
        if mode == "adaptive":      # the exits really diverge
            assert len(set(to_np(got.iter).tolist())) > 1


def test_solve_instance_ops_with_cones_and_cone_args_matches_jax():
    fields, tilt, glide = landing_parts(N)
    _pj, cache_j, cones_j, _pt, cache_t, cones_t = lander_pair(N)
    bl = lambda v, n: np.broadcast_to(v, (n,) + np.shape(v)).astype(np.float32)
    pf = {k: bl(v, B) for k, v in fields.items()}
    pj = atm_j.Problem(**{k: jnp.asarray(v) for k, v in pf.items()})
    pt = convert.problem_from_numpy(pf, device=DEV)
    cb_j = atm_j.Cache(**{k: jnp.asarray(bl(np.asarray(v), B))
                          for k, v in fields_of(cache_j).items()})
    cb_t = convert.cache_from_numpy(fields_of(cb_j), device=DEV)
    x0s = perturbed_x0(LANDER_X0, B, seed=3, spread=0.3).astype(np.float32)
    mu_u = np.linspace(0.6, 1.4, B, dtype=np.float32)[None]
    axis_x = [np.asarray([2, 2, 2, 1, 2, 2])]
    ball_x = [np.asarray([[1, 1, 0, 0, 0, 0]] * 3 + [[1, 0, 0, 0, 0, 0]]
                         + [[1, 1, 0, 0, 0, 0]] * 2, np.float32)]
    args_j = cj.make_cone_args(cones_j, B, 6, 3, mu_u=mu_u, ball_x=ball_x,
                               axis_x=axis_x)
    args_t = ct.make_cone_args(cones_t, B, 6, 3, mu_u=mu_u, ball_x=ball_x,
                               axis_x=axis_x, device=DEV)
    sj = atm_j.Settings(max_iter=25, check_termination=0)
    zeros_j = boj.OpsState.zeros(B, N * 6, (N - 1) * 3)
    zeros_t = bot.OpsState.zeros(B, N * 6, (N - 1) * 3, device=DEV)
    ops_j = boj.build_instance_ops(pj, cb_j)
    ops_t = bot.build_instance_ops(pt, cb_t)
    for a_j, a_t in ((None, None), (args_j, args_t)):
        want = boj.solve_instance_ops(
            jnp.asarray(x0s), zeros_j, ops_j, sj, cones=cones_j, dims=(6, 3),
            cone_args=a_j)
        got = bot.solve_instance_ops(
            torch.as_tensor(x0s), zeros_t, ops_t, settings_to_torch(sj),
            cones=cones_t, dims=(6, 3), cone_args=a_t)
        assert_fields_close(got, want, atol=1e-4, scaled=True,
                            names=["D", "Y", "G", "Z", "V", "U", "X"])
    with pytest.raises(ValueError, match="require dims"):
        bot.solve_instance_ops(torch.as_tensor(x0s), zeros_t, ops_t,
                               settings_to_torch(sj), cones=cones_t)


ADAPT = dict(abs_pri_tol=0.02, abs_dua_tol=0.02, check_termination=1)


@pytest.mark.parametrize("refresh", ["exact", "first_order"])
def test_adaptive_rho_batched_float64_matches_jax(refresh):
    with jax.enable_x64(True):
        pj, _cache_j, pt, _cache_t, x0s = _both(np.float64)
        # finite bounds: the first-order mode differences every operator field
        box = lambda a, v: np.full(np.shape(a), v)
        pj = pj.replace(u_min=jnp.asarray(box(pj.u_min, -5.0)),
                        u_max=jnp.asarray(box(pj.u_max, 5.0)),
                        x_min=jnp.asarray(box(pj.x_min, -50.0)),
                        x_max=jnp.asarray(box(pj.x_max, 50.0)))
        pt = convert.problem_from_numpy(fields_of(pj), dtype=torch.float64,
                                        device=DEV)
        sj = atm_j.Settings(**ADAPT)
        kw = dict(chunk=25, max_rounds=12, refresh=refresh, riccati="vmap")
        want = jax.jit(lambda x, r: boj.solve_adaptive_rho_batched(
            x, pj, pj.A, pj.B, pj.Q, pj.R, r, sj, **kw))(
                jnp.asarray(x0s), jnp.asarray(RHO0))
        got = bot.solve_adaptive_rho_batched(
            torch.as_tensor(x0s), pt, pt.A, pt.B, pt.Q, pt.R,
            torch.as_tensor(RHO0), settings_to_torch(sj), **kw)
        assert got.rounds == int(want.rounds)
        np.testing.assert_array_equal(to_np(got.total_iter),
                                      np.asarray(want.total_iter))
        np.testing.assert_array_equal(to_np(got.state.solved),
                                      np.asarray(want.state.solved))
        np.testing.assert_allclose(to_np(got.rho), np.asarray(want.rho),
                                   rtol=1e-9)
        assert_fields_close(got.state, want.state, atol=1e-8, scaled=True,
                            names=["U", "X", "D", "Z", "V"])
        assert_fields_close(got.cache, want.cache, atol=1e-8, scaled=True,
                            names=["Kinf", "Pinf"])
        assert bool(got.state.solved.all())
        np.testing.assert_array_equal(to_np(got.rho[:2]), [1.0, 1.0])
        # the rescue is real: the instances that start at rho = 1e3 moved
        # (those at 1e-3 meet the tolerance before the guard can fire)
        assert (to_np(got.rho[4:]) != RHO0[4:]).all()


@pytest.mark.parametrize("riccati", ["vmap", "kernel", "newton"])
@pytest.mark.parametrize("refresh", ["exact", "cold"])
def test_adaptive_rho_batched_rescues_misscaled(f32, riccati, refresh):
    _pj, _cache_j, pt, _cache_t, x0s = f32
    st = atm_t.Settings(**ADAPT)
    res = bot.solve_adaptive_rho_batched(
        torch.as_tensor(x0s), pt, pt.A, pt.B, pt.Q, pt.R,
        torch.as_tensor(RHO0, dtype=torch.float32), st, chunk=25,
        max_rounds=20, refresh=refresh, riccati=riccati)
    assert bool(res.state.solved.all()), res.total_iter
    iters = to_np(res.total_iter).astype(np.float64)
    assert iters[2:].max() <= 8 * iters[:2].max() + 100
    np.testing.assert_array_equal(to_np(res.rho[:2]), [1.0, 1.0])
    # without adaptation the mis-scaled instances do not get there
    ops0, _ = bot.build_instance_ops_from_plants(
        pt.A, pt.B, pt.Q, pt.R, torch.as_tensor(RHO0, dtype=torch.float32),
        pt, riccati="vmap")
    fixed = bot.solve_instance_ops(
        torch.as_tensor(x0s),
        bot.OpsState.zeros(B, N * NX, (N - 1) * NU, device=DEV), ops0,
        st.replace(max_iter=res.rounds * 25))
    assert not bool(fixed.solved[2:].all())


def test_adaptive_rho_batched_validates_and_chunked_agrees(f32):
    _pj, _cache_j, pt, _cache_t, x0s = f32
    st = atm_t.Settings(**ADAPT)
    args = (torch.as_tensor(x0s), pt, pt.A, pt.B, pt.Q, pt.R,
            torch.as_tensor(RHO0, dtype=torch.float32))
    with pytest.raises(ValueError, match="alpha"):
        bot.solve_adaptive_rho_batched(*args, st.replace(alpha=1.5))
    with pytest.raises(ValueError, match="refresh must be"):
        bot.solve_adaptive_rho_batched(*args, st, refresh="warm")
    with pytest.raises(ValueError, match="unknown riccati"):
        bot.solve_adaptive_rho_batched(*args, st, riccati="lu")
    kw = dict(chunk=25, max_rounds=20, riccati="vmap")
    whole = bot.solve_adaptive_rho_batched(*args, st, **kw)
    parts = bot.solve_adaptive_rho_chunked(*args, st, batch_chunk=4, **kw)
    np.testing.assert_array_equal(to_np(parts.total_iter),
                                  to_np(whole.total_iter))
    np.testing.assert_allclose(to_np(parts.rho), to_np(whole.rho), rtol=1e-5)
    np.testing.assert_allclose(to_np(parts.state.U), to_np(whole.state.U),
                               atol=1e-4)
    assert parts.cache.Kinf.shape == (B, NU, NX)
    assert parts.rounds == whole.rounds


# ------------------------------------------------- single-instance adaptive --

def _single(rho, dtype=np.float64):
    p, _ = random_lti_j(seed=2, nx=NX, nu=NU, horizon=N)
    pf = {k: np.asarray(v, dtype) for k, v in fields_of(p).items()}
    pj = atm_j.Problem(**{k: jnp.asarray(v) for k, v in pf.items()})
    cache_j = riccati_cache_j(pf["A"], pf["B"], pf["Q"], pf["R"], rho,
                              dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pt = convert.problem_from_numpy(pf, dtype=tdt, device=DEV)
    cache_t = convert.cache_from_numpy(fields_of(cache_j), dtype=tdt,
                                       device=DEV)
    x0 = (np.random.default_rng(9).standard_normal(NX) * 0.4).astype(dtype)
    return pj, cache_j, pt, cache_t, x0


@pytest.mark.parametrize("mode", ["device", "f64_refresh", "first_order"])
def test_solve_adaptive_rho_single_float64_matches_jax(mode):
    with jax.enable_x64(True):
        pj, cache_j, pt, cache_t, x0 = _single(1e3)
        sj = atm_j.Settings(abs_pri_tol=1e-3, abs_dua_tol=1e-3)
        s0 = atm_j.init_state(NX, NU, N, dtype=jnp.float64)
        s0 = atm_j.set_x0(s0, jnp.asarray(x0))
        kw = dict(max_total_iter=600, f64_refresh=mode == "f64_refresh",
                  first_order=mode == "first_order")
        want = arj.solve_adaptive_rho(s0, pj, cache_j, sj, **kw)
        got = art.solve_adaptive_rho(
            state_to_torch(s0, torch.float64), pt, cache_t,
            settings_to_torch(sj), **kw)
        assert got.iterations == want.iterations
        assert got.converged == want.converged and got.converged
        assert len(got.rho_history) == len(want.rho_history) > 1
        # the JAX loop clips rho through a float32 scalar
        np.testing.assert_allclose(got.rho_history, want.rho_history,
                                   rtol=1e-6)
        np.testing.assert_allclose(to_np(got.state.u), np.asarray(want.state.u),
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(got.cache.Kinf),
                                   np.asarray(want.cache.Kinf), atol=1e-5)


# ----------------------------------------------------------------- TinyMPC --

def _mpc_pair(tier, batch, settings, **kw):
    """The lander through both packages' TinyMPC with the example's cones."""
    pj, cache_j, cones_j, pt, cache_t, cones_t = lander_pair(N)
    mj = atm_j.TinyMPC.from_parts(
        pj, cache_j, settings=atm_j.Settings(**settings), batch=batch,
        tier=tier, interpret=True, cones=cones_j, **kw)
    tkw = {k: (torch.as_tensor(np.asarray(v)) if k.startswith("cone_") else v)
           for k, v in kw.items()}
    mt = atm_t.TinyMPC.from_parts(
        pt, cache_t, settings=atm_t.Settings(**settings), batch=batch,
        tier=tier, device=DEV, cones=cones_t, **tkw)
    x0 = LANDER_X0 if batch is None else perturbed_x0(
        LANDER_X0, batch, seed=3, spread=0.3)
    for m in (mj, mt):
        m.set_x0(x0.astype(np.float32))
    return mj, mt


@pytest.mark.parametrize("tier,batch", [("scan", None), ("scan", 4),
                                        ("condensed", None), ("condensed", 4),
                                        ("fused", None), ("fused", 4)])
def test_tinympc_with_cones_matches_jax(tier, batch):
    mj, mt = _mpc_pair(tier, batch, dict(max_iter=20, check_termination=0))
    mj.solve(), mt.solve()
    np.testing.assert_allclose(mt.get_u(), mj.get_u(), atol=1e-4)
    np.testing.assert_allclose(mt.get_x(), mj.get_x(), atol=2e-4)


def test_tinympc_fused_per_instance_cones_compaction_and_rollout():
    mu = np.linspace(0.6, 1.4, 4, dtype=np.float32)[None]
    settings = dict(max_iter=60, check_termination=2, abs_pri_tol=3e-2,
                    abs_dua_tol=3e-2)
    mj, mt = _mpc_pair("fused", 4, settings, cone_mu=mu,
                       compaction_segment=10)
    sj, st = mj.solve(), mt.solve()
    same = sj["iterations"] == st["iterations"]
    assert same.mean() >= 0.75
    np.testing.assert_allclose(mt.get_u()[same], mj.get_u()[same], atol=1e-4)
    # the cascade changes nothing against the monolithic adaptive solve; held
    # in float64, since compaction changes the batch shape of the products
    # and the CPU's BLAS groups float32 sums by that shape
    _pj, _cj, _cnj, pt64, cache64, cones64 = lander_pair(N, dtype=np.float64)
    x0_64 = perturbed_x0(LANDER_X0, 4, seed=3, spread=0.3).astype(np.float32)
    runs = []
    for seg in ({"compaction_segment": 10}, {}):
        m = atm_t.TinyMPC.from_parts(
            pt64, cache64, settings=atm_t.Settings(**settings), batch=4,
            tier="fused", device=DEV, cones=cones64,
            cone_mu=torch.as_tensor(mu, dtype=torch.float64), **seg)
        m.set_x0(x0_64)
        runs.append((m.solve(), m.get_u()))
    (st64, u_casc), (sp64, u_one) = runs
    np.testing.assert_array_equal(sp64["iterations"], st64["iterations"])
    assert u_one.dtype == np.float64
    np.testing.assert_allclose(u_one, u_casc,
                               atol=1e-12 * max(1.0, np.abs(u_one).max()))
    # coned missions: in-kernel form against the tick loop, and against JAX
    mj, mt = _mpc_pair("fused", 4, dict(max_iter=15, check_termination=0))
    _, mt2 = _mpc_pair("fused", 4, dict(max_iter=15, check_termination=0))
    xf_j, us_j = mj.rollout(3)
    xf_t, us_t = mt.rollout(3, in_kernel=True)
    xf_l, us_l = mt2.rollout(3, in_kernel=False)
    np.testing.assert_allclose(to_np(us_t), np.asarray(us_j)[..., :3],
                               atol=1e-4)
    np.testing.assert_allclose(to_np(xf_t), np.asarray(xf_j), atol=1e-4)
    np.testing.assert_allclose(to_np(us_t), to_np(us_l), atol=1e-5)


def test_tinympc_solve_adaptive_rho_single_and_batched():
    pj, cache_j, pt, cache_t, x0 = _single(1e3, np.float32)
    sj = dict(abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    mt = atm_t.TinyMPC.from_parts(pt, cache_t, tier="fused", device=DEV,
                                  settings=atm_t.Settings(**sj))
    mt.set_x0(x0)
    out = mt.solve_adaptive_rho(max_total_iter=600)
    assert out["solved"] and len(out["rho_history"]) > 1
    assert float(mt.cache.rho) == pytest.approx(out["rho"])
    assert mt._pp.rho_f == pytest.approx(out["rho"])   # operators rebuilt
    K_new = atm_t.riccati_cache(pt.A, pt.B, pt.Q, pt.R, out["rho"], device=DEV)
    np.testing.assert_allclose(to_np(mt.cache.Kinf), to_np(K_new.Kinf),
                               atol=1e-3)
    # the next fused solve runs on operators of the adapted cache: it equals
    # the solve of an object built from that cache (the JAX object keeps the
    # operators of the old cache here, ROADMAP.md section 3)
    fixed = atm_t.Settings(max_iter=40, check_termination=0)
    mt.settings = fixed
    mt._fused_carry = mt._fused_carry._replace(
        **{k: torch.zeros_like(v) for k, v in mt._fused_carry._asdict().items()})
    mt.solve()
    fresh = atm_t.TinyMPC.from_parts(pt, mt.cache, tier="fused", device=DEV,
                                     settings=fixed)
    fresh.set_x0(x0)
    fresh.solve()
    np.testing.assert_allclose(mt.get_u(), fresh.get_u(), atol=1e-6)
    # batched, against the JAX object: same plant, x0 spread, mis-scaled rho
    x0s = perturbed_x0(x0, 4, seed=1, spread=0.2).astype(np.float32)
    mj = atm_j.TinyMPC.from_parts(pj, cache_j, batch=4,
                                  settings=atm_j.Settings(**sj))
    mb = atm_t.TinyMPC.from_parts(pt, cache_t, batch=4, device=DEV,
                                  settings=atm_t.Settings(**sj))
    mj.set_x0(x0s), mb.set_x0(x0s)
    want = mj.solve_adaptive_rho(riccati="vmap", max_rounds=20)
    got = mb.solve_adaptive_rho(riccati="vmap", max_rounds=20)
    assert got["converged_fraction"] == want["converged_fraction"] == 1.0
    assert set(got) == set(want)
    assert got["rho"].shape == (4,) and (got["rho"] < 1e3).all()
    assert abs(got["rounds"] - want["rounds"]) <= 1


def test_tinympc_slack_getter_and_adaptive_rho_result():
    from accelerated_tinympc_tpu_torch.solver.cones import cone_violation

    # every final slack satisfies every cone, on a kernel tier and on scan
    for tier, batch in (("fused", 4), ("scan", None)):
        _, mt = _mpc_pair(tier, batch, dict(max_iter=20, check_termination=0))
        mt.solve()
        z, v = mt.get_slacks()
        lead = () if batch is None else (batch,)
        assert z.shape == lead + (N - 1, 3) and v.shape == lead + (N, 6)
        for w, cone in ((z, mt.cones.input_cones[0]),
                        (v, mt.cones.state_cones[0])):
            assert float(cone_violation(torch.as_tensor(w), cone)) <= 1e-5
    # the fused tier's slacks follow a rollout too
    _, mt = _mpc_pair("fused", 4, dict(max_iter=15, check_termination=0))
    mt.rollout(2, in_kernel=True)
    z, _v = mt.get_slacks()
    np.testing.assert_array_equal(
        z.reshape(4, -1), to_np(mt._fused_carry.Z))
    # per-instance starting penalties, and the result behind the stats
    _pj, _cj, pt, cache_t, x0 = _single(1e3, np.float32)
    sj = dict(abs_pri_tol=1e-2, abs_dua_tol=1e-2)
    one = atm_t.TinyMPC.from_parts(pt, cache_t, device=DEV,
                                   settings=atm_t.Settings(**sj))
    with pytest.raises(ValueError, match="needs batch"):
        one.solve_adaptive_rho(rho0=np.ones(1))
    mb = atm_t.TinyMPC.from_parts(pt, cache_t, batch=4, device=DEV,
                                  settings=atm_t.Settings(**sj))
    mb.set_x0(perturbed_x0(x0, 4, seed=1, spread=0.2).astype(np.float32))
    assert mb.adaptive_rho_result is None
    rho0 = np.asarray([1e3, 1.0, 1e3, 1.0], np.float32)
    got = mb.solve_adaptive_rho(riccati="vmap", max_rounds=20, rho0=rho0)
    assert got["converged_fraction"] == 1.0
    assert (got["rho"][[0, 2]] < 1e3).all()       # the mis-scaled ones adapt
    np.testing.assert_array_equal(got["rho"][[1, 3]], rho0[[1, 3]])
    res = mb.adaptive_rho_result
    np.testing.assert_array_equal(to_np(res.rho), got["rho"])
    assert bool(torch.isfinite(res.state.U).all())
