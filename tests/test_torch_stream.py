"""PyTorch port, streaming long-horizon tier (``ops/stream_admm.py``, kernels
K9/K10, and ``solver/cascade.py::stream_cascade_solve``) against the JAX
package on the CPU. The port's wrappers take their plain version for CPU
tensors; the oracle is the JAX scan tier ``solve_batched`` (the reference
the JAX package's own stream tests hold its kernel to), plus the pure-JAX
layout helpers. No JAX stream kernel runs here, not even interpreted.

Bars: float64 at 1e-9 with equal iteration counts and solved flags;
float32 at 1e-4 relative to each field's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_tinympc_tpu as atm_j
from accelerated_tinympc_tpu.ops import stream_admm as sj
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched, solve_batched,
)
from accelerated_tinympc_tpu.types import SOLVED, Problem
from accelerated_tinympc_tpu_torch import convert
from accelerated_tinympc_tpu_torch.ops import stream_admm as st
from accelerated_tinympc_tpu_torch.solver.cascade import stream_cascade_solve

from torch_parity_utils import DEV, assert_fields_close, cache_to_torch, to_np

NX, NU, N = 6, 2, 48
B = 9
ADAPT = dict(check_termination=5, abs_pri_tol=5e-3, abs_dua_tol=5e-3)


def _fields(n=N, seed=0, bound=0.7, knot=False):
    rng = np.random.default_rng(seed)
    A = np.eye(NX) + 0.02 * rng.standard_normal((NX, NX))
    Bm = 0.2 * rng.standard_normal((NX, NU))
    Q = np.abs(rng.standard_normal(NX)) + 1.0
    R = np.abs(rng.standard_normal(NU)) + 1.0
    u = np.full((n - 1, NU), bound)
    if knot:  # a tightening input schedule and a state corridor
        u = u * np.linspace(1.5, 0.5, n - 1)[:, None]
    f = dict(A=A, B=Bm, Q=Q, R=R, u_min=-u, u_max=u,
             x_min=np.full((n, NX), -4.0), x_max=np.full((n, NX), 4.0),
             Xref=0.1 * rng.standard_normal((n, NX)),
             Uref=np.zeros((n - 1, NU)))
    if knot:
        f["x_max"][n // 2:, 0] = 0.3
    return f, riccati_cache(A, Bm, Q, R, rho=1.0)


def _x0s(batch=B, seed=1):
    rng = np.random.default_rng(seed)
    scale = np.repeat([0.05, 0.4, 2.0], -(-batch // 3))[:batch, None]
    return scale * rng.standard_normal((batch, NX))


def _jax_scan(fields, cache, x0s, dtype, max_iter, check=0, tol=0.0,
              project=None):
    """The JAX scan tier. Fixed mode runs with a check at the last
    iteration and tolerance 0, which records that iteration's residuals
    and never freezes."""
    pj = Problem(**{k: jnp.asarray(v, dtype) for k, v in fields.items()})
    cj = jax.tree.map(lambda a: jnp.asarray(a, dtype), cache)
    s = atm_j.Settings(max_iter=max_iter,
                       check_termination=check or max_iter,
                       abs_pri_tol=tol, abs_dua_tol=tol)
    stt = init_state_batched(x0s.shape[0], NX, NU, pj.horizon, dtype)
    stt = stt.replace(x=stt.x.at[:, 0, :].set(jnp.asarray(x0s, dtype)))
    return jax.jit(lambda q: solve_batched(q, pj, cj, s, project=project))(
        stt)


def _torch_sp(fields, cache, tdt):
    pt = convert.problem_from_numpy(fields, dtype=tdt, device=DEV)
    ct = cache_to_torch(cache, tdt)
    return st.pad_stream_problem(pt, ct, dtype=tdt)


def _assert_vs_scan(res, want, *, atol, scaled, counts=True, check=0):
    """A port StreamResult against a JAX scan-tier State. ``check > 0``
    (float32 adaptive runs): an instance whose residual sits on the
    tolerance at a check may freeze one check later in one float32 version
    than in the other (summation order); at most one instance may, by one
    check block, and the values are compared on the others."""
    it_g = to_np(res.stats[:, 0]).astype(int)
    it_w = to_np(want.iter).astype(int)
    rows = slice(None)
    if check:
        same = it_g == it_w
        assert (~same).sum() <= 1 and np.abs(it_g - it_w).max() <= check, \
            (it_g, it_w)
        rows = np.nonzero(same)[0]
    elif counts:
        np.testing.assert_array_equal(it_g, it_w)
    got = dict(U=res.U, X=res.X, d=res.carry.d, y=res.carry.y,
               g=res.carry.g, z=res.carry.z, v=res.carry.v,
               res=res.stats[:, 2:6])
    ref = dict(U=want.u, X=want.x, d=want.d, y=want.y, g=want.g, z=want.z,
               v=want.v, res=np.stack([
                   to_np(want.primal_residual_state),
                   to_np(want.dual_residual_state),
                   to_np(want.primal_residual_input),
                   to_np(want.dual_residual_input)], 1))
    assert_fields_close({k: to_np(v)[rows] for k, v in got.items()},
                        {k: to_np(v)[rows] for k, v in ref.items()},
                        atol=atol, scaled=scaled)


@pytest.fixture(scope="module")
def f64_fixed():
    fields, cache = _fields()
    x0s = _x0s()
    with jax.enable_x64(True):
        want = _jax_scan(fields, cache, x0s, jnp.float64, 30)
        want = jax.tree.map(np.asarray, want)
    return fields, cache, x0s, want


@pytest.fixture(scope="module")
def f64_adaptive():
    fields, cache = _fields()
    x0s = _x0s()
    with jax.enable_x64(True):
        want = _jax_scan(fields, cache, x0s, jnp.float64, 60,
                         check=ADAPT["check_termination"],
                         tol=ADAPT["abs_pri_tol"])
        want = jax.tree.map(np.asarray, want)
    return fields, cache, x0s, want


def test_pad_stream_problem_vs_jax():
    """The port's operands equal the JAX ones, unpacked from their padded
    lanes (uniform bounds, then per-knot schedules), and the tracking
    rebuild of qc/pterm matches too."""
    for knot in (False, True):
        fields, cache = _fields(knot=knot)
        pj = Problem(**{k: jnp.asarray(v, jnp.float32)
                        for k, v in fields.items()})
        spj = sj.pad_stream_problem(pj, cache)
        jf = {f: getattr(spj, f) for f in (
            "A", "B", "Kinf", "Quu_inv", "AmBKt", "u_min", "u_max", "x_min",
            "x_max", "qc", "pterm", "rho", "u_min_k", "u_max_k", "x_min_k",
            "x_max_k")}
        want = convert.stream_problem_from_numpy(
            {k: None if v is None else np.asarray(v) for k, v in jf.items()},
            (NX, NU, N), device=DEV)
        got = _torch_sp(fields, cache, torch.float32)
        assert got.has_knot_bounds == knot == spj.has_knot_bounds
        assert_fields_close(got, want, atol=1e-6)
        rng = np.random.default_rng(3)
        Xref = rng.standard_normal((N, NX)).astype(np.float32)
        spj2 = sj.stream_ref_vectors(spj, pj.Q, jnp.asarray(cache.Pinf,
                                                            jnp.float32),
                                     jnp.asarray(Xref))
        got2 = st.stream_ref_vectors(
            got, torch.as_tensor(fields["Q"], dtype=torch.float32),
            torch.as_tensor(cache.Pinf, dtype=torch.float32),
            torch.as_tensor(Xref))
        np.testing.assert_allclose(to_np(got2.qc),
                                   np.asarray(spj2.qc)[:, :NX, 0], atol=1e-6)
        np.testing.assert_allclose(to_np(got2.pterm),
                                   np.asarray(spj2.pterm)[:NX, 0], atol=1e-5)


def test_stream_carry_converters():
    """The JAX packed carry (NT, N, S, 128) converts to the port's
    batch-leading layout and back, padding checked."""
    rng = np.random.default_rng(4)
    Bn = 130  # two lane tiles
    raw = {k: rng.standard_normal((Bn, N - 1 if k in "dyz" else N,
                                   NU if k in "dyz" else NX))
           .astype(np.float32) for k in "dygzv"}
    packed = {k: np.array(sj._pack(jnp.asarray(
        np.concatenate([a, np.zeros((Bn, 1, NU), np.float32)], 1)
        if k in "dyz" else a), Bn, 8)) for k, a in raw.items()}
    c = convert.stream_carry_from_numpy(packed, (NX, NU, N), batch=Bn,
                                        device=DEV)
    for k in "dygzv":
        np.testing.assert_array_equal(to_np(getattr(c, k)), raw[k])
    back = convert.stream_carry_to_numpy(c)
    for k in "dygzv":
        np.testing.assert_array_equal(back[k], packed[k])
    packed["d"][0, 3, 7, 0] = 1.0  # a padding row
    with pytest.raises(ValueError, match="padding"):
        convert.stream_carry_from_numpy(packed, (NX, NU, N), device=DEV)


def test_jax_warm_carry_and_operands_carry_across(f64_fixed):
    """A JAX warm start in the stream tier's packed layout (here the JAX
    scan tier's iterates after 20 iterations, packed by the JAX package's
    own ``_pack``) and the JAX operands, both converted, continue in the
    port exactly as the JAX scan tier continues: 20 + 10 = 30 iterations."""
    fields, cache, x0s, want = f64_fixed
    with jax.enable_x64(True):
        st20 = jax.tree.map(np.asarray, _jax_scan(fields, cache, x0s,
                                                  jnp.float64, 20))
        pj = Problem(**{k: jnp.asarray(v, jnp.float64)
                        for k, v in fields.items()})
        spj = sj.pad_stream_problem(pj, cache, dtype=jnp.float64)
        pad = lambda a: np.concatenate([a, np.zeros_like(a[:, :1])], 1)
        packed = {k: np.asarray(sj._pack(jnp.asarray(
            pad(getattr(st20, k)) if k in "dyz" else getattr(st20, k)),
            B, 8)) for k in "dygzv"}
        jf = {f: getattr(spj, f) for f in (
            "A", "B", "Kinf", "Quu_inv", "AmBKt", "u_min", "u_max", "x_min",
            "x_max", "qc", "pterm", "rho", "u_min_k")}
        sp = convert.stream_problem_from_numpy(
            {k: None if v is None else np.asarray(v) for k, v in jf.items()},
            (NX, NU, N), dtype=torch.float64, device=DEV)
    carry = convert.stream_carry_from_numpy(packed, (NX, NU, N), batch=B,
                                            dtype=torch.float64, device=DEV)
    res = st.stream_solve(torch.as_tensor(x0s), carry, sp, max_iter=10)
    _assert_vs_scan(res, want, atol=1e-9, scaled=True, counts=False)


def test_fixed_f64_exact(f64_fixed):
    """Fixed 30 iterations in float64: every field and the residual stats
    equal the scan tier's to 1e-9."""
    fields, cache, x0s, want = f64_fixed
    sp = _torch_sp(fields, cache, torch.float64)
    x0 = torch.as_tensor(x0s)
    res = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=30)
    _assert_vs_scan(res, want, atol=1e-9, scaled=True)
    assert not res.stats[:, 1].any()


def test_fixed_f32_vs_scan():
    """The float32 version against the JAX float32 scan tier, 1e-4 relative."""
    fields, cache = _fields()
    x0s = _x0s()
    want = jax.tree.map(np.asarray, _jax_scan(fields, cache, x0s,
                                              jnp.float32, 30))
    sp = _torch_sp(fields, cache, torch.float32)
    x0 = torch.as_tensor(x0s, dtype=torch.float32)
    res = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=30)
    _assert_vs_scan(res, want, atol=1e-4, scaled=True)


def test_warm_start_chain_and_knot_block(f64_fixed):
    """20 + 10 iterations through the carry equal one 30-iteration solve;
    knot_block 8, 16 and 64 give the same bits."""
    fields, cache, x0s, want = f64_fixed
    sp = _torch_sp(fields, cache, torch.float64)
    x0 = torch.as_tensor(x0s)
    a = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=20)
    b = st.stream_solve(x0, a.carry, sp, max_iter=10)
    _assert_vs_scan(b, want, atol=1e-9, scaled=True, counts=False)
    outs = [st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp,
                            max_iter=12, knot_block=kb) for kb in (8, 16, 64)]
    for o in outs[1:]:
        for f in ("U", "X", "stats"):
            assert torch.equal(getattr(o, f), getattr(outs[0], f))


def test_adaptive_f64_exact(f64_adaptive):
    """Per-instance early exit: iteration counts and solved flags equal the
    scan tier's, every frozen field to 1e-9 in float64."""
    fields, cache, x0s, want = f64_adaptive
    sp = _torch_sp(fields, cache, torch.float64)
    res = st.stream_solve(torch.as_tensor(x0s), st.StreamCarry.zeros(B, sp),
                          sp, max_iter=60, **ADAPT)
    _assert_vs_scan(res, want, atol=1e-9, scaled=True)
    np.testing.assert_array_equal(to_np(res.stats[:, 1]) > 0.5,
                                  want.status == SOLVED)
    assert len(np.unique(want.iter)) > 2, "no termination spread"


def test_adaptive_f32_vs_scan():
    fields, cache = _fields()
    x0s = _x0s()
    want = jax.tree.map(np.asarray, _jax_scan(
        fields, cache, x0s, jnp.float32, 60, check=5, tol=5e-3))
    sp = _torch_sp(fields, cache, torch.float32)
    res = st.stream_solve(torch.as_tensor(x0s, dtype=torch.float32),
                          st.StreamCarry.zeros(B, sp), sp, max_iter=60,
                          **ADAPT)
    _assert_vs_scan(res, want, atol=1e-4, scaled=True, check=5)


def test_per_knot_bounds_and_cones_f64():
    """Per-knot bound schedules and a state cone, float64, fixed and
    adaptive, against the scan tier with the same projection."""
    from accelerated_tinympc_tpu.solver import cones as cj
    from accelerated_tinympc_tpu_torch.solver import cones as ct

    fields, cache = _fields(knot=True)
    x0s = _x0s()
    cone = ((0, 1), 2, 1.2, 0.5)
    with jax.enable_x64(True):
        proj = cj.cone_slack_update(cj.ConeSet(state_cones=(cj.Cone(*cone),)))
        want_f = jax.tree.map(np.asarray, _jax_scan(
            fields, cache, x0s, jnp.float64, 25, project=proj))
        want_a = jax.tree.map(np.asarray, _jax_scan(
            fields, cache, x0s, jnp.float64, 40, check=5, tol=5e-3,
            project=proj))
    sp = _torch_sp(fields, cache, torch.float64)
    assert sp.has_knot_bounds
    cones = ct.ConeSet(state_cones=(ct.Cone(*cone),))
    x0 = torch.as_tensor(x0s)
    res = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=25,
                          cones=cones)
    _assert_vs_scan(res, want_f, atol=1e-9, scaled=True)
    res = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=40,
                          cones=cones, **ADAPT)
    _assert_vs_scan(res, want_a, atol=1e-9, scaled=True)


def test_bounds_disabled(f64_fixed):
    """en_*_bound=False skips the box clips (reference admm.cpp:50-60)."""
    fields, cache, x0s, _ = f64_fixed
    free = dict(fields, u_min=np.full_like(fields["u_min"], -np.inf),
                u_max=np.full_like(fields["u_max"], np.inf),
                x_min=np.full_like(fields["x_min"], -np.inf),
                x_max=np.full_like(fields["x_max"], np.inf))
    sp = _torch_sp(fields, cache, torch.float64)
    sp_free = _torch_sp(free, cache, torch.float64)
    x0 = torch.as_tensor(x0s)
    a = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=10,
                        en_input_bound=False, en_state_bound=False)
    b = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp_free, max_iter=10)
    assert torch.equal(a.U, b.U) and torch.equal(a.X, b.X)


def test_stream_cascade_inkernel(f64_adaptive):
    """Adaptive segments + compaction equal one long adaptive call: counts,
    flags, iterates, carry and residuals (float64, 1e-12)."""
    fields, cache, x0s, _ = f64_adaptive
    sp = _torch_sp(fields, cache, torch.float64)
    x0 = torch.as_tensor(x0s)
    one = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp, max_iter=60,
                          **ADAPT)
    trace = []
    U, X, stats, carry = stream_cascade_solve(
        x0, st.StreamCarry.zeros(B, sp), sp, max_iter=60, segment_iters=10,
        segment_growth=1.0, trace=trace, **ADAPT)
    assert len(trace) > 1 and trace[-1][1] < B
    assert torch.equal(stats[:, :2], one.stats[:, :2])
    assert_fields_close(dict(U=U, X=X, stats=stats, **carry._asdict()),
                        dict(U=one.U, X=one.X, stats=one.stats,
                             **one.carry._asdict()), atol=1e-12)
    with pytest.raises(ValueError, match="multiple of check_termination"):
        stream_cascade_solve(x0, st.StreamCarry.zeros(B, sp), sp,
                             segment_iters=12, check_termination=5)
    with pytest.raises(ValueError, match="segment_growth"):
        stream_cascade_solve(x0, st.StreamCarry.zeros(B, sp), sp,
                             segment_growth=0.5)


def test_stream_cascade_fixed_segments(f64_adaptive):
    """Segment-granular mode: each instance's controls equal a
    fixed-iteration solve of its recorded (segment-multiple) count, and the
    solved flags are the convergence predicate at its exit segment."""
    fields, cache, x0s, _ = f64_adaptive
    sp = _torch_sp(fields, cache, torch.float64)
    x0 = torch.as_tensor(x0s)
    U, X, stats, _c = stream_cascade_solve(
        x0, st.StreamCarry.zeros(B, sp), sp, max_iter=60, segment_iters=10,
        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    iters = to_np(stats[:, 0]).astype(int)
    assert set(np.unique(iters)) <= set(range(10, 61, 10))
    assert len(np.unique(iters)) > 1
    for k in np.unique(iters):
        want = st.stream_solve(x0, st.StreamCarry.zeros(B, sp), sp,
                               max_iter=int(k))
        sel = torch.as_tensor(iters == k)
        np.testing.assert_allclose(to_np(U[sel]), to_np(want.U[sel]),
                                   rtol=0, atol=1e-12)
    s = to_np(stats)
    ok = (s[:, 2] < 5e-3) & (s[:, 4] < 5e-3) & (s[:, 3] < 5e-3) \
        & (s[:, 5] < 5e-3)
    np.testing.assert_array_equal(s[:, 1] > 0.5, ok)


def test_refuses():
    fields, cache = _fields()
    sp = _torch_sp(fields, cache, torch.float32)
    x0 = torch.zeros((2, NX))
    with pytest.raises(ValueError, match="max_iter >= 1"):
        st.stream_solve(x0, st.StreamCarry.zeros(2, sp), sp, max_iter=0)
    with pytest.raises(ValueError, match="knot_block"):
        st.stream_solve(x0, st.StreamCarry.zeros(2, sp), sp, knot_block=0)
