"""PyTorch port, heterogeneous-plant tier (``ops/hetero_admm.py``): the plain
version against the JAX package's hetero kernel (Pallas interpreter, one
call in a module fixture), its scan tier and its instance-ops tier (cones
with per-instance parameters and geometry), against the JAX scan tier with per-instance
plants (``solve_batched(problem_axes=0)``, float64 exact schedules), the
compaction cascade against one adaptive call, and the JAX carry carried
across by ``convert``.

Bars: float32 1e-4 on every field (two float32 implementations order their
sums differently; 40 iterations of these plants move a rounding to ~1e-6),
stats equal on the iteration and solved columns; float64 iteration counts
exactly equal and u0 within 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.ops import hetero_admm as hj
from accelerated_tinympc_tpu.precompute import riccati_cache as riccati_cache_j
from accelerated_tinympc_tpu.solver import cones as cj
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched as init_batched_j,
    solve_batched as solve_batched_j,
)
import accelerated_tinympc_tpu_torch as atm_t
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.ops import hetero_admm as ht
from accelerated_tinympc_tpu_torch.solver import cones as ctn
from accelerated_tinympc_tpu_torch.solver.batched import (
    init_state_batched, solve_batched,
)
from accelerated_tinympc_tpu_torch.solver.cascade import hetero_cascade_solve

from torch_parity_utils import DEV, fields_of, to_np

B, NX, NU, N = 6, 5, 2, 5      # a ragged shape: no dimension a power of two
ATOL = 1e-4
FIXED = dict(max_iter=30, check_termination=0)
ADAPT = dict(max_iter=40, check_termination=2, abs_pri_tol=5e-3,
             abs_dua_tol=5e-3)
CONE_U = ((0,), 1, 1.2, 0.5)           # (ball, axis, mu, shift)
CONE_X = ((0, 1), 2, 2.0, 0.5)


def _jax_parts(dtype=np.float32):
    probs, caches = [], []
    rng = np.random.default_rng(7)
    for seed in range(B):
        p, rho = random_lti_problem(seed=seed, nx=NX, nu=NU, horizon=N)
        lim = 0.4 + 0.1 * rng.random((N - 1, NU))      # per-knot, per-instance
        p = p.replace(u_min=jnp.asarray(-lim, p.A.dtype),
                      u_max=jnp.asarray(lim, p.A.dtype),
                      x_min=jnp.full((N, NX), -4.0), x_max=jnp.full((N, NX), 4.0),
                      Xref=jnp.asarray(0.1 * rng.standard_normal((N, NX)),
                                       p.A.dtype))
        caches.append(riccati_cache_j(np.asarray(p.A), np.asarray(p.B),
                                      np.asarray(p.Q), np.asarray(p.R), rho,
                                      dtype=dtype))
        probs.append(p)
    stack = lambda trees: jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, dtype) for x in xs]), *trees)
    return stack(probs), stack(caches)


@pytest.fixture(scope="module")
def data():
    pj, cjx = _jax_parts()
    pt = convert.problem_from_numpy(fields_of(pj), device=DEV)
    ct = convert.cache_from_numpy(fields_of(cjx), device=DEV)
    x0 = (0.5 * np.random.default_rng(3).standard_normal((B, NX))).astype(
        np.float32)
    return pj, cjx, pt, ct, x0


def _cone_sets():
    return (cj.ConeSet(input_cones=(cj.Cone(*CONE_U),),
                       state_cones=(cj.Cone(*CONE_X),)),
            ctn.ConeSet(input_cones=(ctn.Cone(*CONE_U),),
                        state_cones=(ctn.Cone(*CONE_X),)))


def _cone_overrides():
    """Per-instance mu/shift for both cones; the input cone's axis on u[0]
    (ball u[1]) for the second half of the fleet."""
    mu_u = np.linspace(0.8, 1.6, B)[None].astype(np.float32)
    shift_x = np.linspace(0.3, 0.7, B)[None].astype(np.float32)
    ball = np.zeros((B, NU), np.float32)
    ball[:B // 2, 0] = 1.0
    ball[B // 2:, 1] = 1.0
    axis = np.full(B, 1, np.int64)
    axis[B // 2:] = 0
    return mu_u, shift_x, ball, axis


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX oracles: the hetero kernel in the Pallas interpreter once
    (adaptive, check 2: the snapshot semantics and both kinds of residual
    stats); the scan tier with per-instance plants for the fixed solve,
    checking only at the last iteration with a tolerance of 0 so that its
    residual fields are the final iteration's against the penultimate
    slacks, as the fixed kernel reports them; the instance-ops tier for the
    coned solve with per-instance parameters and geometry. Only the first
    runs the interpreter."""
    from accelerated_tinympc_tpu.solver import batched_ops as bj

    pj, cjx, _pt, _ct, x0 = data
    hp = hj.pad_hetero_problem(pj, cjx)
    x = jnp.asarray(x0)
    cones_j, _ = _cone_sets()
    mu_u, shift_x, ball, axis = _cone_overrides()
    cone_args = cj.make_cone_args(cones_j, B, NX, NU, mu_u=mu_u,
                                  shift_x=shift_x, ball_u=[ball],
                                  axis_u=[axis])
    coned = jax.jit(bj.solve_instance_ops, static_argnames=("cones", "dims"))(
        x, bj.OpsState.zeros(B, N * NX, (N - 1) * NU),
        bj.build_instance_ops(pj, cjx), atm_j.Settings(**FIXED),
        cones=cones_j, dims=(NX, NU), cone_args=cone_args)
    st = init_batched_j(B, NX, NU, N)
    st = st.replace(x=st.x.at[:, 0, :].set(x))
    last_check = atm_j.Settings(max_iter=FIXED["max_iter"],
                                check_termination=FIXED["max_iter"],
                                abs_pri_tol=0.0, abs_dua_tol=0.0)
    fixed = jax.jit(lambda s: solve_batched_j(
        s, pj, cjx, last_check, problem_axes=0, cache_axes=0))(st)
    return {
        "adaptive": hj.hetero_solve(x, hj.HeteroCarry.zeros(hp), hp,
                                    interpret=True, **ADAPT),
        "fixed": fixed,
        "cones": coned,
    }


def _scan_as_port(st):
    """The JAX scan tier's batched ``State`` as a port ``HeteroResult``."""
    t = lambda a: torch.as_tensor(np.array(to_np(a)))
    stats = torch.zeros((B, 8))
    stats[:, 0] = t(st.iter).float()
    stats[:, 1] = (t(st.status) == 1).float()
    for k, f in enumerate(("primal_residual_state", "dual_residual_state",
                           "primal_residual_input", "dual_residual_input")):
        stats[:, 2 + k] = t(getattr(st, f))
    return ht.HeteroResult(
        ht.HeteroCarry(d=t(st.d), y=t(st.y), g=t(st.g), z=t(st.z),
                       v=t(st.v)), t(st.u), t(st.x), stats)


def _ops_as_port(st):
    """The JAX instance-ops state as a port ``HeteroResult``."""
    u = lambda a: torch.as_tensor(np.array(to_np(a))).reshape(B, N - 1, NU)
    x = lambda a: torch.as_tensor(np.array(to_np(a))).reshape(B, N, NX)
    stats = torch.zeros((B, 8))
    stats[:, 0] = torch.as_tensor(np.array(to_np(st.iter))).float()
    stats[:, 1] = torch.as_tensor(np.array(to_np(st.solved))).float()
    for k, f in enumerate(("pri_s", "dua_s", "pri_u", "dua_u")):
        stats[:, 2 + k] = torch.as_tensor(np.array(to_np(getattr(st, f))))
    return ht.HeteroResult(
        ht.HeteroCarry(d=u(st.D), y=u(st.Y), g=x(st.G), z=u(st.Z),
                       v=x(st.V)), u(st.U), x(st.X), stats)


def _as_port(jres):
    return convert.hetero_result_from_numpy({
        "U": to_np(jres.U), "X": to_np(jres.X), "stats": to_np(jres.stats),
        "carry": {k: to_np(getattr(jres.carry, k))
                  for k in ("d", "y", "g", "z", "v")}}, (NX, NU, N), device=DEV)


def _assert_result_close(got, want, atol=ATOL):
    np.testing.assert_array_equal(to_np(got.stats[:, :2]),
                                  to_np(want.stats[:, :2]))
    for k in ("U", "X"):
        np.testing.assert_allclose(to_np(getattr(got, k)),
                                   to_np(getattr(want, k)), atol=atol,
                                   err_msg=k)
    for k in ("d", "y", "g", "z", "v"):
        np.testing.assert_allclose(to_np(getattr(got.carry, k)),
                                   to_np(getattr(want.carry, k)), atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(to_np(got.stats[:, 2:]),
                               to_np(want.stats[:, 2:]), rtol=1e-3,
                               atol=atol)


def _port_cones(pt):
    _, cones_t = _cone_sets()
    mu_u, shift_x, ball, axis = _cone_overrides()
    cp = ht.pad_hetero_cone_params(cones_t, B, mu_u=mu_u, shift_x=shift_x)
    cm = ht.pad_hetero_cone_masks(cones_t, B, NX, NU, ball_u=[ball],
                                  axis_u=[axis])
    return cones_t, cp, cm


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "cones"])
def test_plain_matches_jax(data, jax_runs, mode):
    """Every field and stat of ``hetero_solve`` (plain on the CPU) against
    JAX (see ``jax_runs``): the adaptive solve against the JAX kernel, its
    lane-packed carry converted by ``convert``; the fixed one against the
    scan tier; the coned one against the instance-ops tier (fields, counts
    and primal residuals: that tier keeps no dual residuals in fixed
    mode)."""
    _pj, _cj, pt, ct, x0 = data
    hp = ht.pad_hetero_problem(pt, ct)
    kw = dict(ADAPT if mode == "adaptive" else FIXED)
    if mode == "cones":
        cones_t, cp, cm = _port_cones(pt)
        kw.update(cones=cones_t, cone_params=cp, cone_masks=cm)
    got = ht.hetero_solve(torch.as_tensor(x0), ht.HeteroCarry.zeros(hp), hp,
                          **kw)
    if mode == "cones":
        want = _ops_as_port(jax_runs[mode])
        got = got._replace(stats=got.stats[:, [0, 1, 2, 2, 4, 4]])
        want = want._replace(stats=want.stats[:, [0, 1, 2, 2, 4, 4]])
    elif mode == "fixed":
        want = _scan_as_port(jax_runs[mode])
    else:
        want = _as_port(jax_runs[mode])
    _assert_result_close(got, want)
    if mode == "adaptive":
        assert len(set(to_np(got.stats[:, 0]).tolist())) > 1  # exits diverge
        assert 0 < float(got.stats[:, 1].sum()) < B   # some run to the cap
    if mode == "cones":   # every final slack inside its own cone
        mu = torch.as_tensor(_cone_overrides()[0][0])
        Z = got.carry.z
        own_axis = torch.where(torch.arange(B) < B // 2, 1, 0)
        s = Z.gather(2, own_axis[:, None, None].expand(B, N - 1, 1))[..., 0]
        ball = Z.gather(2, (1 - own_axis)[:, None, None].expand(
            B, N - 1, 1))[..., 0]
        assert float((ball.abs() - mu[:, None] * (s + 0.5)).max()) <= 1e-5


def test_jax_warm_carry_carries_across(data, jax_runs):
    """A JAX warm carry, converted, warm-starts the port's solve as the
    port's own carry does."""
    _pj, _cj, pt, ct, x0 = data
    hp = ht.pad_hetero_problem(pt, ct)
    x = torch.as_tensor(x0)
    own = ht.hetero_solve(x, ht.HeteroCarry.zeros(hp), hp, **ADAPT).carry
    jc = _as_port(jax_runs["adaptive"]).carry
    a = ht.hetero_solve(x * 0.5, own.reset_duals(), hp, **ADAPT)
    b = ht.hetero_solve(x * 0.5, jc.reset_duals(), hp, **ADAPT)
    _assert_result_close(a, b)
    with pytest.raises(ValueError, match="not zero"):
        bad = {k: to_np(getattr(jax_runs["adaptive"].carry, k)).copy()
               for k in ("d", "y", "g", "z", "v")}
        bad["g"][:, -1] = 1.0        # a padding lane
        convert.hetero_carry_from_numpy(bad, (NX, NU, N), batch=B,
                                        device=DEV)


def _scan_pair(x64: bool):
    """The float64 (or float32) port hetero solve and JAX scan tier with
    per-instance plants on the same data."""
    dt = np.float64 if x64 else np.float32
    pj, cjx = _jax_parts(dt)
    tdt = torch.float64 if x64 else torch.float32
    pt = convert.problem_from_numpy(fields_of(pj), dtype=tdt, device=DEV)
    ct = convert.cache_from_numpy(fields_of(cjx), dtype=tdt, device=DEV)
    x0 = 0.5 * np.random.default_rng(3).standard_normal((B, NX))
    return pj, cjx, pt, ct, x0.astype(dt), tdt


@pytest.mark.parametrize("ce", [0, 1])
def test_float64_schedules_equal_jax_scan_tier(ce):
    """In float64 the hetero tier's iteration counts equal the JAX scan
    tier's (per-instance plants) and u0 agrees to 1e-9; so does the port's
    own ``solve_batched(problem_axes=BATCHED)``."""
    with jax.enable_x64(True):
        pj, cjx, pt, ct, x0, tdt = _scan_pair(True)
        s = atm_j.Settings(max_iter=60, check_termination=ce,
                           abs_pri_tol=1e-3, abs_dua_tol=1e-3)
        st = init_batched_j(B, NX, NU, N, jnp.float64)
        st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0)))
        want = solve_batched_j(st, pj, cjx, s, problem_axes=0, cache_axes=0)
    hp = ht.pad_hetero_problem(pt, ct, torch.float64)
    got = ht.hetero_solve(
        torch.as_tensor(x0), ht.HeteroCarry.zeros(hp), hp, max_iter=60,
        check_termination=ce, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    it_w = to_np(want.iter) if ce else np.full(B, 60)
    np.testing.assert_array_equal(to_np(got.stats[:, 0]), it_w)
    np.testing.assert_allclose(to_np(got.U[:, 0]), to_np(want.u[:, 0]),
                               atol=1e-9)
    tst = atm_t.set_x0(init_state_batched(B, NX, NU, N, tdt, DEV),
                       torch.as_tensor(x0))
    sb = solve_batched(tst, pt, ct, atm_t.Settings(
        max_iter=60, check_termination=ce), problem_axes=0, cache_axes=0)
    np.testing.assert_array_equal(to_np(sb.iter), to_np(want.iter))
    np.testing.assert_allclose(to_np(sb.u), to_np(want.u), atol=1e-9)
    np.testing.assert_allclose(to_np(sb.x), to_np(want.x), atol=1e-9)


def test_solve_batched_per_instance_float32_matches_jax():
    pj, cjx, pt, ct, x0, tdt = _scan_pair(False)
    s = atm_j.Settings(max_iter=40, check_termination=2, abs_pri_tol=5e-3,
                       abs_dua_tol=5e-3)
    st = init_batched_j(B, NX, NU, N)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0)))
    want = solve_batched_j(st, pj, cjx, s, problem_axes=0, cache_axes=0)
    tst = atm_t.set_x0(init_state_batched(B, NX, NU, N, tdt, DEV),
                       torch.as_tensor(x0))
    got = solve_batched(tst, pt, ct, atm_t.Settings(
        max_iter=40, check_termination=2, abs_pri_tol=5e-3,
        abs_dua_tol=5e-3), problem_axes=0, cache_axes=0)
    np.testing.assert_array_equal(to_np(got.iter), to_np(want.iter))
    for k in ("u", "x", "z", "v", "y", "g", "d"):
        np.testing.assert_allclose(to_np(getattr(got, k)),
                                   to_np(getattr(want, k)), atol=ATOL,
                                   err_msg=k)


def test_cone_mask_validation_matches_jax():
    _, cones_t = _cone_sets()
    cones_j, _ = _cone_sets()
    for kw, msg in (
            (dict(axis_u=[np.full(B, 2)]), "axis indices"),
            (dict(axis_u=[np.zeros(B, np.int64)]), "overlap")):
        for fn, cones in ((hj.pad_hetero_cone_masks, cones_j),
                          (ht.pad_hetero_cone_masks, cones_t)):
            with pytest.raises(ValueError, match=msg):
                fn(cones, B, NX, NU, **kw)
    # default masks encode the cones' static indices
    m = ht.pad_hetero_cone_masks(cones_t, B, NX, NU)
    assert m.shape == (B, 2 * NU + 2 * NX)
    np.testing.assert_array_equal(to_np(m[:, :NU]), [[1.0, 0.0]] * B)


@pytest.mark.parametrize("coned", [False, True])
def test_hetero_cascade_bit_exact(data, coned):
    """The cascade against one adaptive call: bit for bit, schedules and
    iterates, per-instance cone operands gathered along."""
    _pj, _cj, pt, ct, x0 = data
    hp = ht.pad_hetero_problem(pt, ct)
    kw = dict(check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    if coned:
        cones_t, cp, cm = _port_cones(pt)
        kw.update(cones=cones_t, cone_params=cp, cone_masks=cm)
    x = torch.as_tensor(x0)
    cold = ht.HeteroCarry.zeros(hp)
    one = ht.hetero_solve(x, cold, hp, max_iter=80, **kw)
    trace = []
    U, X, stats, carry = hetero_cascade_solve(
        x, cold, hp, max_iter=80, segment_iters=4, segment_growth=2.0,
        trace=trace, **kw)
    assert len(trace) > 2 and trace[-1][1] < B
    assert torch.equal(U, one.U) and torch.equal(X, one.X)
    assert torch.equal(stats, one.stats)
    for a, b in zip(carry, one.carry):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="requires adaptive mode"):
        hetero_cascade_solve(x, cold, hp, check_termination=0)


def test_gather_repack_and_edge_cases(data):
    _pj, _cj, pt, ct, x0 = data
    hp = ht.pad_hetero_problem(pt, ct)
    x = torch.as_tensor(x0)
    cold = ht.HeteroCarry.zeros(hp)
    idx = torch.tensor([4, 1])
    hp2, c2, x2, cp2, cm2 = ht.gather_hetero(hp, cold, x, idx)
    assert cp2 is None and cm2 is None and hp2.batch == 2
    full = ht.hetero_solve(x, cold, hp, **FIXED)
    part = ht.hetero_solve(x2, c2, hp2, **FIXED)
    assert torch.equal(part.U, full.U[idx])
    # a cache refresh repacks only the cache fields
    ct2 = ct.replace(rho=ct.rho * 2.0)
    hp3 = ht.repack_hetero_caches(hp, ct2, pt.Xref)
    assert torch.equal(hp3.A, hp.A) and torch.equal(hp3.rho, hp.rho * 2.0)
    # max_iter 0: nothing moves, U = X = 0, stats against the carry
    warm = full.carry
    zero = ht.hetero_solve(x, warm, hp, max_iter=0)
    assert torch.equal(zero.carry.d, warm.d) and float(zero.U.abs().max()) == 0
    assert float(zero.stats[0, 2]) == float(warm.v[0].abs().max())
    with pytest.raises(ValueError, match="max_iter >= 1"):
        ht.hetero_solve(x, cold, hp, max_iter=0, check_termination=1)
    with pytest.raises(ValueError, match="without cones"):
        ht.hetero_solve(x, cold, hp, cone_params=torch.zeros(B, 1, 2))
    # kernel limits name the tiers that take larger plants
    with pytest.raises(ValueError, match="instance_ops"):
        ht.launch_geometry((33, 4, 10))
    with pytest.raises(ValueError, match="instance_ops"):
        ht.launch_geometry((32, 32, 400))
    assert ht.launch_geometry((12, 4, 10)) == (16, 8, 8 * 4 * 1092)


def test_pad_from_plants_routes_as_jax(data):
    """On CPU tensors ``riccati="auto"`` is the batched tensor builder,
    ``"kernel"`` the fixed-point kernel's plain version: both the JAX
    on-device builder's cache."""
    from accelerated_tinympc_tpu_torch.precompute import riccati_cache_jax

    _pj, _cj, pt, _ct, _x0 = data
    rho = torch.full((B,), 5.0)
    want = riccati_cache_jax(pt.A, pt.B, pt.Q, pt.R, rho)
    for mode in ("auto", "kernel"):
        hp, caches = ht.pad_hetero_from_plants(pt.A, pt.B, pt.Q, pt.R, rho,
                                               pt, riccati=mode)
        np.testing.assert_allclose(to_np(caches.Kinf), to_np(want.Kinf),
                                   atol=1e-5)
        assert hp.dims == (NX, NU, N)
