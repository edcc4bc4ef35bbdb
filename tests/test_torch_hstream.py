"""PyTorch port, heterogeneous streaming tier (``ops/hstream_admm.py``,
kernels K11/K12, and ``solver/cascade.py::hstream_cascade_solve``) against
the JAX package on the CPU. The port's wrappers take their plain version
for CPU tensors; the oracles are the JAX scan tier with per-instance plants
(``solve_batched(problem_axes=0)``, as the JAX package's own hstream tests
use it), its instance-ops tier for per-instance cone parameters and
geometry, and the pure-JAX layout helpers. No JAX hstream kernel runs here,
not even interpreted.

Bars: float64 at 1e-9 with equal iteration counts and solved flags;
float32 at 1e-4 relative to each field's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.ops import hstream_admm as hj
from accelerated_tinympc_tpu.ops import stream_admm as sj
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver import batched_ops as bj
from accelerated_tinympc_tpu.solver import cones as cj
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched, solve_batched,
)
from accelerated_tinympc_tpu.types import SOLVED, Problem
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.ops import hetero_admm as ht
from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
from accelerated_tinympc_tpu_torch.ops.stream_admm import StreamCarry
from accelerated_tinympc_tpu_torch.solver import cones as ct
from accelerated_tinympc_tpu_torch.solver.cascade import hstream_cascade_solve

from torch_parity_utils import DEV, assert_fields_close, fields_of, to_np

NX, NU, N = 6, 3, 40
B = 6
ADAPT = dict(check_termination=5, abs_pri_tol=5e-3, abs_dua_tol=5e-3)
CONE_U = ((0, 1), 2, 0.9, 1.5)     # (ball, axis, mu, shift)


def _fleet(n=N, batch=B, knot=False, dtype=np.float32):
    """Distinct random plants, per-instance rho, as batch-leading JAX
    Problem/Cache pytrees (caches from the float64 host Riccati)."""
    problems, caches = [], []
    for seed in range(batch):
        rng = np.random.default_rng(seed)
        A = np.eye(NX) + 0.02 * rng.standard_normal((NX, NX))
        Bm = 0.2 * rng.standard_normal((NX, NU))
        Q = np.abs(rng.standard_normal(NX)) + 1.0
        R = np.abs(rng.standard_normal(NU)) + 1.0
        u = np.full((n - 1, NU), 0.7 + 0.1 * seed)
        if knot:
            u = u * np.linspace(1.5, 0.5, n - 1)[:, None]
        caches.append(riccati_cache(A, Bm, Q, R, rho=1.0 + 0.5 * seed,
                                    dtype=dtype))
        problems.append(Problem(
            A=A, B=Bm, Q=Q, R=R, u_min=-u, u_max=u,
            x_min=np.full((n, NX), -4.0), x_max=np.full((n, NX), 4.0),
            Xref=0.1 * rng.standard_normal((n, NX)),
            Uref=np.zeros((n - 1, NU))))
    stack = lambda trees: jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, dtype) for x in xs]), *trees)
    return stack(problems), stack(caches)


def _x0s(batch=B, seed=1):
    rng = np.random.default_rng(seed)
    scale = np.repeat([0.05, 0.4, 2.0], -(-batch // 3))[:batch, None]
    return scale * rng.standard_normal((batch, NX))


def _scan(pj, cjx, x0s, max_iter, check=0, tol=0.0):
    """The JAX scan tier with per-instance plants; fixed mode checks only at
    the last iteration with tolerance 0 (that iteration's residuals, no
    freeze)."""
    dtype = pj.A.dtype
    nx, nu = pj.B.shape[-2:]
    s = atm_j.Settings(max_iter=max_iter, check_termination=check or max_iter,
                       abs_pri_tol=tol, abs_dua_tol=tol)
    st = init_state_batched(x0s.shape[0], nx, nu, pj.Xref.shape[1], dtype)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0s, dtype)))
    out = jax.jit(lambda q: solve_batched(q, pj, cjx, s, problem_axes=0,
                                          cache_axes=0))(st)
    return jax.tree.map(np.asarray, out)


def _torch_hsp(pj, cjx, tdt):
    pt = convert.problem_from_numpy(fields_of(pj), dtype=tdt, device=DEV)
    ctc = convert.cache_from_numpy(fields_of(cjx), dtype=tdt, device=DEV)
    return hs.pad_hstream_problem(pt, ctc, dtype=tdt)


def _assert_vs_scan(res, want, *, atol, check=0):
    """As in test_torch_stream: counts equal, or (``check > 0``, float32
    adaptive) at most one instance a check block away, values compared on
    the others; fields scaled by their largest entry."""
    it_g = to_np(res.stats[:, 0]).astype(int)
    it_w = want.iter.astype(int)
    rows = slice(None)
    if check:
        same = it_g == it_w
        assert (~same).sum() <= 1 and np.abs(it_g - it_w).max() <= check, \
            (it_g, it_w)
        rows = np.nonzero(same)[0]
    else:
        np.testing.assert_array_equal(it_g, it_w)
        np.testing.assert_array_equal(to_np(res.stats[:, 1]) > 0.5,
                                      want.status == SOLVED)
    got = dict(U=res.U, X=res.X, **res.carry._asdict(), res=res.stats[:, 2:6])
    ref = dict(U=want.u, X=want.x, d=want.d, y=want.y, g=want.g, z=want.z,
               v=want.v, res=np.stack([
                   want.primal_residual_state, want.dual_residual_state,
                   want.primal_residual_input, want.dual_residual_input], 1))
    assert_fields_close({k: to_np(v)[rows] for k, v in got.items()},
                        {k: np.asarray(v)[rows] for k, v in ref.items()},
                        atol=atol, scaled=True)


@pytest.fixture(scope="module")
def f64():
    """The float64 fleet with the scan tier's fixed and adaptive results."""
    with jax.enable_x64(True):
        pj, cjx = _fleet(dtype=np.float64)
        x0s = _x0s()
        fixed = _scan(pj, cjx, x0s, 30)
        adaptive = _scan(pj, cjx, x0s, 60, check=5, tol=5e-3)
        pj, cjx = jax.tree.map(np.asarray, (pj, cjx))
    hsp = _torch_hsp(pj, cjx, torch.float64)
    return hsp, torch.as_tensor(x0s), fixed, adaptive


def test_pad_hstream_problem_vs_jax():
    """The port's operands equal the JAX lane-packed ones, unpacked (uniform
    per-instance bounds, then per-knot schedules); the tracking rebuild and
    the on-device build from raw plants agree too."""
    for knot in (False, True):
        pj, cjx = _fleet(knot=knot)
        # traced inputs count as time-uniform there: jit only that case
        hspj = (hj.pad_hstream_problem(pj, cjx) if knot
                else jax.jit(hj.pad_hstream_problem)(pj, cjx))
        want = convert.hstream_problem_from_numpy(
            {k: None if v is None else np.asarray(v)
             for k, v in fields_of(hspj).items()} | {
                k: None for k in ("u_min_k", "u_max_k", "x_min_k", "x_max_k")
                if getattr(hspj, k) is None},
            (NX, NU, N), B, device=DEV)
        got = _torch_hsp(pj, cjx, torch.float32)
        assert got.has_knot_bounds == knot == hspj.has_knot_bounds
        assert_fields_close(got, want, atol=1e-6, scaled=True)
    rng = np.random.default_rng(3)
    Xref = rng.standard_normal((B, N, NX)).astype(np.float32)
    w2 = convert.hstream_problem_from_numpy(fields_of(hj.hstream_ref_vectors(
        hspj, pj.Q, cjx.Pinf, jnp.asarray(Xref))) | {
            k: None for k in ("u_min_k", "u_max_k", "x_min_k", "x_max_k")
            if getattr(hspj, k) is None}, (NX, NU, N), B, device=DEV)
    g2 = hs.hstream_ref_vectors(got, torch.as_tensor(np.array(pj.Q)),
                                torch.as_tensor(np.array(cjx.Pinf)),
                                torch.as_tensor(Xref))
    assert_fields_close(dict(qc=g2.qc, pterm=g2.pterm),
                        dict(qc=w2.qc, pterm=w2.pterm), atol=1e-5,
                        scaled=True)
    # on-device build from raw plants: the batched Riccati caches it returns,
    # packed as pad_hstream_problem packs them
    pt = convert.problem_from_numpy(fields_of(pj), device=DEV)
    built, caches = hs.pad_hstream_from_plants(
        pt.A, pt.B, pt.Q, pt.R, torch.as_tensor(np.array(cjx.rho)), pt)
    assert_fields_close(built, hs.pad_hstream_problem(pt, caches), atol=0.0)
    assert float((caches.Kinf - got.Kinf).abs().max()) < 1e-3


def test_gather_hstream_vs_jax():
    """Gathering instances (the compaction primitive) agrees with the JAX
    gather on a 128-lane index set; the cone operands come along."""
    pj, cjx = _fleet()
    hspj = hj.pad_hstream_problem(pj, cjx)
    rng = np.random.default_rng(5)
    carry = {k: rng.standard_normal((B, N - 1 if k in "dyz" else N,
                                     NU if k in "dyz" else NX))
             .astype(np.float32) for k in "dygzv"}
    pad = lambda a: np.concatenate([a, np.zeros((B, 1, NU), np.float32)], 1)
    cj_carry = sj.StreamCarry(**{k: sj._pack(jnp.asarray(
        pad(a) if k in "dyz" else a), B, 8) for k, a in carry.items()})
    x0 = rng.standard_normal((B, NX)).astype(np.float32)
    idx = np.resize(np.array([4, 1, 1, 3]), 128)
    h2, c2, x2 = hj.gather_hstream(hspj, cj_carry, jnp.asarray(x0),
                                   jnp.asarray(idx))
    want = convert.hstream_problem_from_numpy(
        fields_of(h2) | {k: None for k in ("u_min_k", "u_max_k", "x_min_k",
                                           "x_max_k")}, (NX, NU, N), 128,
        device=DEV)
    hsp = _torch_hsp(pj, cjx, torch.float32)
    tcarry = StreamCarry(**{k: torch.as_tensor(a) for k, a in carry.items()})
    cones = ct.ConeSet(input_cones=(ct.Cone(*CONE_U),))
    cp = ht.pad_hetero_cone_params(cones, B, mu_u=np.linspace(0.5, 1, B)[None])
    got, gc, gx, gcp, gcm = hs.gather_hstream(
        hsp, tcarry, torch.as_tensor(x0), torch.as_tensor(idx), cp)
    assert_fields_close(got, want, atol=1e-6, scaled=True)
    wc = convert.stream_carry_from_numpy(fields_of(c2), (NX, NU, N),
                                         batch=128, device=DEV)
    assert_fields_close(gc, wc, atol=0.0)
    np.testing.assert_array_equal(to_np(gx), np.asarray(x2))
    assert torch.equal(gcp, cp[torch.as_tensor(idx)]) and gcm is None


def test_fixed_f64_exact(f64):
    hsp, x0, fixed, _ = f64
    res = hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp,
                           max_iter=30)
    _assert_vs_scan(res, fixed, atol=1e-9)


def test_adaptive_f64_exact(f64):
    hsp, x0, _, adaptive = f64
    res = hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp,
                           max_iter=60, **ADAPT)
    _assert_vs_scan(res, adaptive, atol=1e-9)
    assert len(np.unique(adaptive.iter)) > 2, "no termination spread"


@pytest.mark.parametrize("adaptive", [False, True])
def test_f32_vs_scan(adaptive):
    pj, cjx = _fleet()
    x0s = _x0s()
    kw = dict(max_iter=60, **ADAPT) if adaptive else dict(max_iter=30)
    want = _scan(pj, cjx, x0s, kw["max_iter"],
                 check=5 if adaptive else 0, tol=5e-3 if adaptive else 0.0)
    hsp = _torch_hsp(pj, cjx, torch.float32)
    res = hs.hstream_solve(torch.as_tensor(x0s, dtype=torch.float32),
                           hs.hstream_carry_zeros(B, hsp), hsp, **kw)
    _assert_vs_scan(res, want, atol=1e-4, check=5 if adaptive else 0)


def test_per_knot_bounds_f64():
    with jax.enable_x64(True):
        pj, cjx = _fleet(knot=True, dtype=np.float64)
        x0s = _x0s()
        want = _scan(pj, cjx, x0s, 40, check=5, tol=5e-3)
        pj, cjx = jax.tree.map(np.asarray, (pj, cjx))
    hsp = _torch_hsp(pj, cjx, torch.float64)
    assert hsp.has_knot_bounds
    res = hs.hstream_solve(torch.as_tensor(x0s), hs.hstream_carry_zeros(B, hsp),
                           hsp, max_iter=40, **ADAPT)
    _assert_vs_scan(res, want, atol=1e-9)


def _cones():
    """The input cone with per-instance mu and, for half the fleet, the
    ball on (u1, u2) and the axis on u0."""
    mu_u = (0.5 + 0.125 * np.arange(B))[None]   # exact in float32 too
    ball = np.zeros((B, NU))
    ball[: B // 2, [0, 1]] = 1.0
    ball[B // 2:, [1, 2]] = 1.0
    axis = np.full(B, 2, np.int64)
    axis[B // 2:] = 0
    return mu_u, ball, axis


def test_per_instance_cones_f64():
    """Per-instance cone mu and geometry: the JAX instance-ops tier (same
    per-instance semantics, pure JAX) as the oracle, float64, adaptive."""
    mu_u, ball, axis = _cones()
    n = 8
    with jax.enable_x64(True):
        pj, cjx = _fleet(n=n, dtype=np.float64)
        x0s = _x0s()
        cones_j = cj.ConeSet(input_cones=(cj.Cone(*CONE_U),))
        args = cj.make_cone_args(cones_j, B, NX, NU, mu_u=mu_u, ball_u=[ball],
                                 axis_u=[axis])
        want = jax.jit(bj.solve_instance_ops,
                       static_argnames=("cones", "dims"))(
            jnp.asarray(x0s), bj.OpsState.zeros(B, n * NX, (n - 1) * NU,
                                                jnp.float64),
            jax.jit(bj.build_instance_ops)(pj, cjx),
            atm_j.Settings(max_iter=60, **ADAPT), cones=cones_j,
            dims=(NX, NU), cone_args=args)
        want = jax.tree.map(np.asarray, want)
        pj, cjx = jax.tree.map(np.asarray, (pj, cjx))
    hsp = _torch_hsp(pj, cjx, torch.float64)
    cones = ct.ConeSet(input_cones=(ct.Cone(*CONE_U),))
    cp = ht.pad_hetero_cone_params(cones, B, mu_u=mu_u, dtype=torch.float64)
    cm = ht.pad_hetero_cone_masks(cones, B, NX, NU, ball_u=[ball],
                                  axis_u=[axis], dtype=torch.float64)
    res = hs.hstream_solve(torch.as_tensor(x0s), hs.hstream_carry_zeros(B, hsp),
                           hsp, max_iter=60, cones=cones, cone_params=cp,
                           cone_masks=cm, **ADAPT)
    np.testing.assert_array_equal(to_np(res.stats[:, 0]).astype(int),
                                  want.iter)
    np.testing.assert_array_equal(to_np(res.stats[:, 1]) > 0.5, want.solved)
    scale = max(1.0, float(np.abs(want.U).max()))
    np.testing.assert_allclose(to_np(res.U).reshape(B, -1), want.U,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(to_np(res.carry.z).reshape(B, -1), want.Z,
                               atol=1e-9 * scale)
    # the overrides bind: the static cone gives other controls
    static = hs.hstream_solve(torch.as_tensor(x0s),
                              hs.hstream_carry_zeros(B, hsp), hsp,
                              max_iter=60, cones=cones, **ADAPT)
    assert float((static.U - res.U).abs().max()) > 1e-3


@pytest.mark.parametrize("coned", [False, True])
def test_hstream_cascade_equals_one_adaptive_call(f64, coned):
    """Adaptive segments + compaction (plants, carries, x0 and the
    per-instance cone operands gathered) equal one long adaptive call."""
    hsp, x0, _, _ = f64
    kw = dict(ADAPT)
    if coned:
        mu_u, ball, axis = _cones()
        cones = ct.ConeSet(input_cones=(ct.Cone(*CONE_U),))
        kw.update(cones=cones, cone_params=ht.pad_hetero_cone_params(
            cones, B, mu_u=mu_u, dtype=torch.float64),
            cone_masks=ht.pad_hetero_cone_masks(
                cones, B, NX, NU, ball_u=[ball], axis_u=[axis],
                dtype=torch.float64))
    cold = hs.hstream_carry_zeros(B, hsp)
    one = hs.hstream_solve(x0, cold, hsp, max_iter=60, **kw)
    trace = []
    U, X, stats, carry = hstream_cascade_solve(
        x0, cold, hsp, max_iter=60, segment_iters=10, segment_growth=1.0,
        trace=trace, **kw)
    assert len(trace) > 1 and trace[-1][1] < B
    assert torch.equal(stats[:, :2], one.stats[:, :2])
    assert_fields_close(dict(U=U, X=X, stats=stats, **carry._asdict()),
                        dict(U=one.U, X=one.X, stats=one.stats,
                             **one.carry._asdict()), atol=1e-12)


def test_hstream_cascade_fixed_segments(f64):
    """Segment-granular mode: controls equal a fixed solve of each recorded
    count; flags are the convergence predicate at the exit segment."""
    hsp, x0, _, _ = f64
    U, _X, stats, _c = hstream_cascade_solve(
        x0, hs.hstream_carry_zeros(B, hsp), hsp, max_iter=60,
        segment_iters=10, abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    iters = to_np(stats[:, 0]).astype(int)
    assert len(np.unique(iters)) > 1
    for k in np.unique(iters):
        want = hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp,
                                max_iter=int(k))
        sel = torch.as_tensor(iters == k)
        np.testing.assert_allclose(to_np(U[sel]), to_np(want.U[sel]),
                                   rtol=0, atol=1e-12)
    s = to_np(stats)
    ok = (s[:, 2] < 5e-3) & (s[:, 4] < 5e-3) & (s[:, 3] < 5e-3) \
        & (s[:, 5] < 5e-3)
    np.testing.assert_array_equal(s[:, 1] > 0.5, ok)


def test_knot_block_invariance_and_refusals(f64):
    hsp, x0, _, _ = f64
    outs = [hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp,
                             max_iter=12, knot_block=kb, **ADAPT)
            for kb in (8, 16, 64)]
    for o in outs[1:]:
        assert torch.equal(o.U, outs[0].U)
        assert torch.equal(o.stats, outs[0].stats)
    with pytest.raises(ValueError, match="without cones"):
        hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp,
                         cone_params=torch.zeros((B, 1, 2)))
    with pytest.raises(ValueError, match="max_iter >= 1"):
        hs.hstream_solve(x0, hs.hstream_carry_zeros(B, hsp), hsp, max_iter=0)


def test_hstream_kernel_plan():
    """The host's plan of the hstream kernels (csrc/stream_admm.cu): the
    compiled bodies for 12/4 and 8/3 (16 lanes an instance, a row a lane),
    the run-time body for every other size (a lane owns ceil((nx + nu) / G)
    rows); the ring's depth from knot_block within 2 .. HSTREAM_KB_MAX and
    the horizon; a refusal past shared memory that names the bytes and the
    scan tier."""
    from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

    plan = sa.hstream_plan(12, 4, 256)
    assert plan == {"kernel": "compiled 12/4", "G": 16, "rows_per_lane": 1,
                    "threads": 128, "instances_per_block": 8, "kb": 8,
                    "smem_bytes": 19_584, "bytes_per_instance": 2_448}
    # per instance (floats): thin rows of B, Kinf' and Quu_inv, the x, p
    # and w buffers, the cone slacks, pterm and uniform bounds, then a ring
    # of 8 knots of d, y, z (4 each) and g, v, qc (12 each)
    thin = 2 * 12 * 4 + 4 * 4
    vecs = 2 * 12 + 2 * 12 + 2 * 4 + (12 + 4) + 12 + 2 * 12 + 2 * 4
    assert 4 * (thin + vecs + 8 * (3 * 4 + 3 * 12)) == 2_448
    assert sa.HSTREAM_SHAPES == ((12, 4), (8, 3))
    assert sa.hstream_plan(8, 3, 256)["kernel"] == "compiled 8/3"
    # per-knot bounds ride in the ring; ten cones add their rows
    assert (sa.hstream_smem_bytes(12, 4, 8, knot_bounds=True)
            - sa.hstream_smem_bytes(12, 4, 8)) == 4 * 8 * (2 * 12 + 2 * 4)
    assert (sa.hstream_smem_bytes(12, 4, 8, nc=10)
            - sa.hstream_smem_bytes(12, 4, 8)) == 4 * 10 * 14
    assert sa.hstream_plan(12, 4, 256, knot_block=3)["kb"] == 3
    assert sa.hstream_plan(12, 4, 256, knot_block=1)["kb"] == 2
    assert sa.hstream_plan(12, 4, 5)["kb"] == 5
    for (nx, nu), rows in (((33, 33), 3), ((40, 12), 2), ((6, 3), 1)):
        p = sa.hstream_plan(nx, nu, 64)
        assert p["kernel"] == "run-time" and p["rows_per_lane"] == rows
        assert p["G"] == (32 if nx + nu > 16 else 16)
        assert p["smem_bytes"] == sa.hstream_smem_bytes(
            nx, nu, p["kb"], instances=p["instances_per_block"])
        assert p["smem_bytes"] <= sa.SMEM_LIMIT_BYTES
    # 33/33: plant rows 2 x 66 x 36, thin rows 99 x 36, vectors, 8 knots of
    # 6 x 36 floats: four instances a block of 128 threads
    wide = sa.hstream_plan(33, 33, 16)
    assert wide["bytes_per_instance"] == 4 * (2 * 66 * 36 + 99 * 36 + 468
                                              + 8 * 216) == 42_048
    assert wide["instances_per_block"] == 4 and wide["kb"] == 8
    # past shared memory even for one instance a block and two knots
    need = sa.hstream_smem_bytes(120, 60, 2)
    assert need > sa.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match=f'need {need} bytes.*tier="scan"'):
        sa.hstream_plan(120, 60, 64)
    # a smaller card's limit: fewer instances a block first, then the ring
    tight = sa.hstream_plan(33, 33, 64, limit=60_000)
    assert tight["instances_per_block"] == 1 and tight["kb"] == 8
    tighter = sa.hstream_plan(33, 33, 64, limit=38_000)
    assert tighter["instances_per_block"] == 1 and 2 <= tighter["kb"] < 8


def _wide_fleet(nx, nu, n, batch, seed):
    """Distinct random plants of any size (float64), batch-leading JAX
    Problem/Cache pytrees, per-instance rho."""
    problems, caches = [], []
    for k in range(batch):
        rng = np.random.default_rng(seed + k)
        A = np.eye(nx) + 0.02 * rng.standard_normal((nx, nx))
        Bm = 0.2 * rng.standard_normal((nx, nu))
        Q = np.abs(rng.standard_normal(nx)) + 1.0
        R = np.abs(rng.standard_normal(nu)) + 1.0
        u = np.full((n - 1, nu), 0.7 + 0.1 * k)
        caches.append(riccati_cache(A, Bm, Q, R, rho=1.0 + 0.5 * k,
                                    dtype=np.float64))
        problems.append(Problem(
            A=A, B=Bm, Q=Q, R=R, u_min=-u, u_max=u,
            x_min=np.full((n, nx), -4.0), x_max=np.full((n, nx), 4.0),
            Xref=0.1 * rng.standard_normal((n, nx)),
            Uref=np.zeros((n - 1, nu))))
    stack = lambda trees: jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float64) for x in xs]),
        *trees)
    return stack(problems), stack(caches)


@pytest.mark.parametrize("dims", [(40, 12, 64), (33, 33, 16)],
                         ids=["40/12/64", "33/33/16"])
def test_past_the_lane_group_limits_f64(dims):
    """What the hstream kernels take since a lane owns several rows: plants
    past 32 states or inputs. The port's hstream tier (its plain version on
    the CPU) against the JAX scan tier with per-instance plants, both in
    float64, fixed 25 iterations and adaptive (check 5): every field to
    1e-9 relative to its largest entry, equal counts and solved flags."""
    nx, nu, n = dims
    batch = 4
    with jax.enable_x64(True):
        pj, cjx = _wide_fleet(nx, nu, n, batch, seed=11)
        rng = np.random.default_rng(12)
        x0s = np.repeat([0.05, 0.4, 2.0, 0.4], 1)[:batch, None] * \
            rng.standard_normal((batch, nx))
        want = {0: _scan(pj, cjx, x0s, 25),
                5: _scan(pj, cjx, x0s, 60, check=5, tol=5e-3)}
        pj, cjx = jax.tree.map(np.asarray, (pj, cjx))
    hsp = _torch_hsp(pj, cjx, torch.float64)
    assert hsp.dims == (nx, nu, n)
    x0 = torch.as_tensor(x0s)
    for check, it in ((0, 25), (5, 60)):
        kw = dict(ADAPT) if check else {}
        res = hs.hstream_solve_plain(
            x0, hs.hstream_carry_zeros(batch, hsp), hsp, max_iter=it, **kw)
        _assert_vs_scan(res, want[check], atol=1e-9)
