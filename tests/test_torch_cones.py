"""PyTorch port, second-order cones on the CPU: the cone projections and the
coned scan / condensed / fused-plain tiers against the JAX package on the
same numpy inputs (the powered-descent lander of examples/soc_landing.py,
nx=6, nu=3, and a quadrotor thrust-tilt cone).

Bars: projections 1e-6; float32 tiers 1e-4 relative to the field's largest
entry; float64 1e-10 with equal iteration counts. The JAX fused kernel runs
in interpret mode as tests/test_fused.py runs it."""

import importlib

import jax
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
from accelerated_tinympc_tpu.solver import batched as bj
from accelerated_tinympc_tpu.solver import condensed as cdj
from accelerated_tinympc_tpu.solver import cones as cj
from accelerated_tinympc_tpu_torch.ops import fused_admm as ft
from accelerated_tinympc_tpu_torch.ops.fused_rollout import (
    fused_rollout as fused_rollout_t, rollout_ops as rollout_ops_t,
)
from accelerated_tinympc_tpu_torch.solver import batched as bt
from accelerated_tinympc_tpu_torch.solver import condensed as cdt
from accelerated_tinympc_tpu_torch.solver import cones as ct

# ops.fused_rollout is the function there; this is its module
frj = importlib.import_module("accelerated_tinympc_tpu.ops.fused_rollout")

from torch_parity_utils import (
    DEV, LANDER_X0, assert_fields_close, assert_fused_close, lander_pair,
    perturbed_x0, settings_to_torch, to_np, torch_pp,
)

N = 8
B = 6


# ------------------------------------------------------------ projections --

CONES = {
    "tilt": ((0, 1), 2, 1.0, 3.0),
    "glide": ((0, 1), 2, 2.0, 0.1),
    "three_ball": ((0, 2, 3), 1, 0.5, 0.0),
    "negative_shift": ((1,), 0, 0.7, -0.4),
}


def _points(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) * 2.0
    w[0] = 0.0                       # the apex: a == 0 and s == shift
    w[1, ..., :] = 0.0
    return w.astype(np.float32)


@pytest.mark.parametrize("name", list(CONES))
def test_project_cone_matches_jax(name):
    w = _points(0, (5, 7, 4))
    got = ct.project_cone(torch.as_tensor(w), ct.Cone(*CONES[name]))
    want = cj.project_cone(jnp.asarray(w), cj.Cone(*CONES[name]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    # a projection: idempotent, and inside the cone afterwards
    again = ct.project_cone(got, ct.Cone(*CONES[name]))
    np.testing.assert_allclose(to_np(again), to_np(got), atol=1e-5)
    assert float(ct.cone_violation(got, ct.Cone(*CONES[name]))) <= 1e-5
    np.testing.assert_allclose(
        float(ct.cone_violation(torch.as_tensor(w), ct.Cone(*CONES[name]))),
        float(cj.cone_violation(jnp.asarray(w), cj.Cone(*CONES[name]))),
        atol=1e-5)


@pytest.mark.parametrize("case", ["static", "mu_shift", "geometry"])
def test_project_cone_masked_matches_jax(case):
    rng = np.random.default_rng(1)
    w = _points(1, (5, 7, 4))
    kw = {}
    if case != "static":
        kw["mu"] = rng.uniform(0.3, 2.0, 5).astype(np.float32)
        kw["shift"] = rng.uniform(-0.2, 1.0, 5).astype(np.float32)
    if case == "geometry":
        axis = rng.integers(0, 4, 5)
        ball = np.ones((5, 4), np.float32)
        ball[np.arange(5), axis] = 0.0
        ball[np.arange(5), (axis + 1) % 4] = 0.0
        am = np.zeros((5, 4), np.float32)
        am[np.arange(5), axis] = 1.0
        kw["ball_mask"], kw["axis_mask"] = ball, am
    cone = CONES["tilt"]
    got = ct.project_cone_masked(
        torch.as_tensor(w), ct.Cone(*cone),
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = cj.project_cone_masked(
        jnp.asarray(w), cj.Cone(*cone),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    if case == "static":
        np.testing.assert_allclose(
            to_np(got),
            to_np(ct.project_cone(torch.as_tensor(w), ct.Cone(*cone))),
            atol=1e-6)


def test_make_cone_args_matches_jax_and_validates():
    cs_t = ct.ConeSet(input_cones=(ct.Cone(*CONES["tilt"]),),
                      state_cones=(ct.Cone(*CONES["glide"]),))
    cs_j = cj.ConeSet(input_cones=(cj.Cone(*CONES["tilt"]),),
                      state_cones=(cj.Cone(*CONES["glide"]),))
    mu = np.linspace(0.5, 1.5, 4, dtype=np.float32)[None]
    axis = [np.asarray([2, 2, 1, 2])]
    ball = [np.asarray([[1, 1, 0]] * 2 + [[1, 0, 0]] + [[1, 1, 0]], np.float32)]
    got = ct.make_cone_args(cs_t, 4, 6, 3, mu_u=mu, ball_u=ball, axis_u=axis,
                            device=DEV)
    want = cj.make_cone_args(cs_j, 4, 6, 3, mu_u=mu, ball_u=ball, axis_u=axis)
    for g_group, w_group in zip(got, want):
        for g, w in zip(g_group, w_group):
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(to_np(a), np.asarray(b))
    with pytest.raises(ValueError, match="axis indices"):
        ct.make_cone_args(cs_t, 4, 6, 3, axis_u=[np.asarray([0, 1, 2, 3])],
                          device=DEV)
    with pytest.raises(ValueError, match="overlap"):
        ct.make_cone_args(cs_t, 4, 6, 3, axis_u=[np.asarray([2, 2, 0, 2])],
                          device=DEV)


# ------------------------------------------------------------------ tiers --

def _settings_j(**kw):
    # 3e-2: the cold lander meets it after 46-49 iterations, instance by
    # instance, so the early exits really diverge inside max_iter.
    base = dict(max_iter=80, check_termination=1, abs_pri_tol=3e-2,
                abs_dua_tol=3e-2)
    base.update(kw)
    return atm_j.Settings(**base)


def _x0s(dtype=np.float32):
    return perturbed_x0(LANDER_X0, B, seed=3, spread=0.3).astype(dtype)


@pytest.fixture(scope="module")
def lander():
    return lander_pair(N)


def _scan_both(lander_parts, x0s, settings_j, dtype=np.float32):
    pj, cache_j, cones_j, pt, cache_t, cones_t = lander_parts
    sj = bj.init_state_batched(B, 6, 3, N, dtype=jnp.dtype(dtype))
    sj = sj.replace(x=sj.x.at[:, 0, :].set(jnp.asarray(x0s)))
    want = jax.jit(lambda s: bj.solve_batched(
        s, pj, cache_j, settings_j,
        project=cj.cone_slack_update(cones_j)))(sj)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    st = bt.init_state_batched(B, 6, 3, N, tdt, DEV)
    st = atm_t.set_x0(st, torch.as_tensor(x0s))
    got = bt.solve_batched(
        st, pt, cache_t, settings_to_torch(settings_j),
        project=ct.cone_slack_update(cones_t))
    return got, want


def test_scan_with_cones_matches_jax(lander):
    got, want = _scan_both(lander, _x0s(), _settings_j())
    assert_fields_close(got, want, atol=1e-4, scaled=True,
                        names=["x", "u", "z", "v", "y", "g", "znew", "vnew"])
    same = to_np(got.iter) == np.asarray(want.iter)
    assert same.mean() >= 0.8
    cones_t = lander[5]
    assert float(ct.cone_violation(got.znew, cones_t.input_cones[0])) <= 1e-5
    assert float(ct.cone_violation(got.vnew, cones_t.state_cones[0])) <= 1e-5


def test_scan_with_cones_float64_exact_schedule():
    with jax.enable_x64(True):
        parts = lander_pair(N, dtype=np.float64)
        got, want = _scan_both(parts, _x0s(np.float64), _settings_j(),
                               dtype=np.float64)
        np.testing.assert_array_equal(to_np(got.iter), np.asarray(want.iter))
        np.testing.assert_array_equal(to_np(got.status),
                                      np.asarray(want.status))
        assert len(set(to_np(got.iter).tolist())) > 1
        assert_fields_close(got, want, atol=1e-10, scaled=True,
                            names=["x", "u", "z", "v", "y", "g"])


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_condensed_with_cones_matches_jax(lander, mode):
    pj, cache_j, cones_j, pt, cache_t, cones_t = lander
    settings_j = _settings_j(
        max_iter=30, check_termination=0 if mode == "fixed" else 1)
    x0s = _x0s()
    ops_j = condensed_operators_j(cache_j, np.asarray(pj.A), np.asarray(pj.B), N)
    sj = cdj.init_flat_state(B, 6, 3, N)
    sj = sj.replace(x0=jnp.asarray(x0s))
    want = cdj.solve_condensed(
        sj, cdj.flatten_problem(pj, cache_j), ops_j, settings_j, 6,
        cones=cones_j, nu=3)
    ops_t, _ = torch_pp(pt, cache_t)
    st = cdt.init_flat_state(B, 6, 3, N, device=DEV)
    st = st.replace(x0=torch.as_tensor(x0s))
    got = cdt.solve_condensed(
        st, cdt.flatten_problem(pt, cache_t), ops_t,
        settings_to_torch(settings_j), 6, cones=cones_t, nu=3)
    assert_fields_close(got, want, atol=1e-4, scaled=True,
                        names=["X", "U", "Z", "V", "Y", "G", "D"])
    with pytest.raises(ValueError, match="require nu"):
        cdt.solve_condensed(
            st, cdt.flatten_problem(pt, cache_t), ops_t,
            settings_to_torch(settings_j), 6, cones=cones_t)


def _fused_setup(lander_parts):
    pj, cache_j, cones_j, pt, cache_t, cones_t = lander_parts
    ops_j = condensed_operators_j(cache_j, np.asarray(pj.A), np.asarray(pj.B), N)
    ppj = fj.pad_problem(pj, cache_j, ops_j)
    _, ppt = torch_pp(pt, cache_t)
    return ppj, fj.pad_cones(ppj, cones_j), ppt, ft.pad_cones(ppt, cones_t)


PER_INSTANCE = {
    "static": {},
    "mu_u": {"cone_mu_u": np.linspace(0.6, 1.4, B, dtype=np.float32)[None]},
    "all": {
        "cone_mu_u": np.linspace(0.6, 1.4, B, dtype=np.float32)[None],
        "cone_shift_u": np.linspace(2.5, 3.5, B, dtype=np.float32)[None],
        "cone_mu_x": np.linspace(1.5, 2.5, B, dtype=np.float32)[None],
        "cone_shift_x": np.linspace(0.05, 0.2, B, dtype=np.float32)[None],
    },
}


@pytest.mark.parametrize("case", list(PER_INSTANCE))
def test_fused_plain_with_cones_matches_jax_kernel(lander, case):
    ppj, cops_j, ppt, cops_t = _fused_setup(lander)
    x0s = _x0s()
    kw = dict(max_iter=20, check_termination=0)
    pj_kw = {k: jnp.asarray(v) for k, v in PER_INSTANCE[case].items()}
    pt_kw = {k: torch.as_tensor(v) for k, v in PER_INSTANCE[case].items()}
    want = fj.fused_solve(
        jnp.asarray(x0s), fj.FusedCarry.zeros(B, ppj), ppj, batch_tile=B,
        interpret=True, cone_ops=cops_j, **pj_kw, **kw)
    got = ft.fused_solve(
        torch.as_tensor(x0s), ft.FusedCarry.zeros(B, ppt, device=DEV), ppt,
        cone_ops=cops_t, **pt_kw, **kw)
    assert_fused_close(got, want, ppt.dims, atol=1e-4)


def test_fused_plain_cones_equal_static_when_rows_repeat_them(lander):
    _ppj, _cops_j, ppt, cops_t = _fused_setup(lander)
    x0 = torch.as_tensor(_x0s())
    cold = ft.FusedCarry.zeros(B, ppt, device=DEV)
    kw = dict(max_iter=40, check_termination=2, cone_ops=cops_t)
    a = ft.fused_solve(x0, cold, ppt, **kw)
    b = ft.fused_solve(
        x0, cold, ppt, cone_mu_u=torch.full((1, B), 1.0),
        cone_shift_x=torch.full((1, B), 0.1), **kw)
    for k in ("D", "Y", "G", "Z", "V"):
        assert torch.equal(getattr(a.carry, k), getattr(b.carry, k)), k
    assert torch.equal(a.stats, b.stats)
    with pytest.raises(ValueError, match="without the matching cones"):
        ft.fused_solve(x0, cold, ppt, cone_mu_u=torch.ones((1, B)),
                       max_iter=5)


def test_fused_plain_adaptive_with_cones_matches_jax_scan(lander):
    """The fused-plain adaptive schedule with cones against the JAX scan
    tier: iteration counts on >= 80 % of instances, controls where equal."""
    ppj, cops_j, ppt, cops_t = _fused_setup(lander)
    x0s = _x0s()
    got = ft.fused_solve(
        torch.as_tensor(x0s), ft.FusedCarry.zeros(B, ppt, device=DEV), ppt,
        max_iter=80, check_termination=1, abs_pri_tol=3e-2,
        abs_dua_tol=3e-2, cone_ops=cops_t)
    _, want = _scan_both(lander, x0s, _settings_j())
    it_g, it_w = to_np(got.stats[:, 0]), np.asarray(want.iter)
    same = it_g == it_w
    assert same.mean() >= 0.8, (it_g, it_w)
    u_w = np.asarray(want.u).reshape(B, -1)
    np.testing.assert_allclose(to_np(got.U)[same], u_w[same], atol=1e-4)
    Z = got.carry.Z.reshape(B, N - 1, 3)
    V = got.carry.V.reshape(B, N, 6)
    cs = cops_t.cones
    assert float(ct.cone_violation(Z, cs.input_cones[0])) <= 1e-5
    assert float(ct.cone_violation(V, cs.state_cones[0])) <= 1e-5


def test_fused_rollout_with_cones_matches_jax_kernel(lander):
    pj, _cache_j, _cones_j, pt, _cache_t, _cones_t = lander
    ppj, cops_j, ppt, cops_t = _fused_setup(lander)
    x0s = _x0s()
    kw = dict(max_iter=12, check_termination=0)
    want = frj.fused_rollout(
        jnp.asarray(x0s), fj.FusedCarry.zeros(B, ppj), ppj,
        frj.rollout_ops(pj, ppj), 3, batch_tile=B, interpret=True,
        cone_ops=cops_j, **kw)
    got = fused_rollout_t(
        torch.as_tensor(x0s), ft.FusedCarry.zeros(B, ppt, device=DEV), ppt,
        rollout_ops_t(pt, ppt, device=DEV), 3, cone_ops=cops_t, **kw)
    np.testing.assert_allclose(to_np(got.us), np.asarray(want.us)[..., :3],
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got.x_final),
                               np.asarray(want.x_final)[:, :6], atol=1e-4)
    assert_fused_close(got.final, want.final, ppt.dims, atol=1e-4)


def test_pad_cones_validates(lander):
    _ppj, _cops_j, ppt, cops_t = _fused_setup(lander)
    assert (cops_t.nc_u, cops_t.nc_x) == (1, 1)
    assert cops_t.idx[:4] == (1, 1, 2, 2)     # counts; first cone: nball, axis
    bad = ct.ConeSet(input_cones=(ct.Cone((0, 1), 3, 1.0),))
    with pytest.raises(ValueError, match="indices must be in"):
        ft.pad_cones(ppt, bad)
    # any number of cones: the kernels read a table sized at run time
    many = ft.pad_cones(ppt, ct.ConeSet(input_cones=(ct.Cone((0,), 1, 1.0),) * 9))
    assert many.nc_u == 9 and len(many.par) == 18
    assert many.table.tolist()[:2] == [9, 12]    # row offsets: 9 + 3 per cone
    with pytest.raises(ValueError, match="axis is in the ball"):
        ft.pad_cones(ppt, ct.ConeSet(input_cones=(ct.Cone((0, 2), 2, 1.0),)))
