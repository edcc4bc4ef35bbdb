"""Heterogeneous-plant fused solve: one distinct plant per instance.

Counterpart of the JAX package's ``ops/hetero_admm.py``. The reference binds
one plant per process (global workspace, reference:
src/tinympc/tiny_wrapper.hpp:6); the per-instance-operator tier
(:mod:`..solver.batched_ops`) inverts that but reads ~13 KB of condensed
operators per instance per iteration. This tier keeps only the plant and
its cache per instance (A, B, Kinf, Quu_inv, AmBKt: ~2 KB at nx=12, nu=4) and
runs both horizon recurrences of every ADMM iteration as per-instance
matrix-vector products: the forward rollout (reference:
src/tinympc/admm.cpp:27-37) fused with the slack projection (:45-61) and the
dual ascent (:67-71), then the backward gradient recursion (:15-22) with
``r``/``q`` rebuilt from the post-update slacks (:77-85).

**Layout.** Batch-leading and unpadded: ``A (B, nx, nx)``, ``B (B, nx, nu)``,
``Kinf (B, nu, nx)``, per-knot per-instance bounds ``(B, N-1, nu)`` /
``(B, N, nx)``, a carry of ``d, y, z (B, N-1, nu)`` and ``g, v (B, N, nx)``.
``stats (B, 8)`` holds ``[iterations, solved, pri_state, dua_state,
pri_input, dua_input, 0, 0]`` as in the JAX package. The TPU's lane
packing, sublane padding and the gather helpers that exist for its strides
(``gather_hetero_rows``, ``cone_rows_per_tile``) are not carried over:
:func:`gather_hetero` is an ``index_select`` that takes the per-instance cone
operands along.

**Modes.** ``check_termination == 0``: ``max_iter`` iterations (kernel K7);
the residual stats compare the final slacks with the penultimate ones.
``> 0``: per-instance early exit with the reference's snapshot semantics
(kernel K8): an instance that converges at check iteration ``kc`` keeps D
from before the backward pass, Z and V from before the slack save, Y and G
advanced, U and X of that iteration, and reports ``kc``; its residual stats
are those of the last check made while it was live.

**Cones.** ``cones`` (a :class:`..solver.cones.ConeSet`) adds exact SOC
projections after the box clip; ``cone_params`` (:func:`pad_hetero_cone_params`)
overrides mu/shift per instance and ``cone_masks``
(:func:`pad_hetero_cone_masks`) the ball/axis geometry per instance.

:func:`hetero_solve` launches the CUDA kernels (``csrc/hetero_admm.cu``) for
tensors on a CUDA device and takes :func:`hetero_solve_plain` only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..types import Cache, Problem, _Struct
from ..utils.debugging import check_outputs

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products

# Launches per kernel, counted where (and only where) the wrapper launches it.
LAUNCH_COUNTS = {"hetero_solve_fixed": 0, "hetero_solve_adaptive": 0}

# csrc/hetero_admm.cu: the shapes compiled with their rows in registers (the
# robust sweep's quadrotor family, the timed one, and the design sweep's
# 8/3 family; every other runs the run-time body, as far as one instance's
# knots, rows and cone operands fit a block's shared memory), the most rows
# a lane owns, the threads of a block at most.
HETERO_SHAPES = ((12, 4), (8, 3))
ROWS_MAX = 8
THREADS = 128
SMEM_LIMIT_BYTES = 232_448


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class HeteroProblem(_Struct):
    """Per-instance operands of the hetero tier, batch-leading.

    ``qc = -(Q o Xref)`` per knot and ``pterm = -Pinf^T Xref_{N-1}`` are the
    reference-dependent linear-cost terms (reference:
    src/tinympc/admm.cpp:81-84); ``rho (B,)`` is each instance's penalty."""

    A: torch.Tensor        # (B, nx, nx)
    B: torch.Tensor        # (B, nx, nu)
    Kinf: torch.Tensor     # (B, nu, nx)
    Quu_inv: torch.Tensor  # (B, nu, nu)
    AmBKt: torch.Tensor    # (B, nx, nx)
    u_min: torch.Tensor    # (B, N-1, nu)
    u_max: torch.Tensor
    x_min: torch.Tensor    # (B, N, nx)
    x_max: torch.Tensor
    qc: torch.Tensor       # (B, N, nx)
    pterm: torch.Tensor    # (B, nx)
    rho: torch.Tensor      # (B,)
    dims: tuple = ()       # (nx, nu, N)

    @property
    def batch(self) -> int:
        return self.A.shape[0]


class HeteroCarry(NamedTuple):
    """Warm-start iterate set; ``zeros`` for a cold start, a solve's returned
    carry warm-starts the next (reference: solve-to-solve workspace reuse)."""

    d: torch.Tensor  # (B, N-1, nu)
    y: torch.Tensor
    g: torch.Tensor  # (B, N, nx)
    z: torch.Tensor  # (B, N-1, nu)
    v: torch.Tensor  # (B, N, nx)

    @staticmethod
    def zeros(hp: HeteroProblem, dtype=None) -> "HeteroCarry":
        nx, nu, N = hp.dims
        dt = hp.A.dtype if dtype is None else dtype
        fu = lambda: torch.zeros((hp.batch, N - 1, nu), dtype=dt,
                                 device=hp.A.device)
        fx = lambda: torch.zeros((hp.batch, N, nx), dtype=dt,
                                 device=hp.A.device)
        return HeteroCarry(d=fu(), y=fu(), g=fx(), z=fu(), v=fx())

    def reset_duals(self) -> "HeteroCarry":
        """Zero y/g between ticks (reference: tiny_wrapper.cpp:131-140)."""
        return self._replace(y=torch.zeros_like(self.y),
                             g=torch.zeros_like(self.g))


class HeteroResult(NamedTuple):
    """``U (B, N-1, nu)`` / ``X (B, N, nx)`` final pre-projection iterates
    (the reference applies pre-projection u); ``stats (B, 8)``:
    [iterations, solved, pri_state, dua_state, pri_input, dua_input, 0, 0]."""

    carry: HeteroCarry
    U: torch.Tensor
    X: torch.Tensor
    stats: torch.Tensor


# ----------------------------------------------------------------- packing --

def _pterm(Xref: torch.Tensor, Pinf: torch.Tensor) -> torch.Tensor:
    return -torch.matmul(Xref[:, -1, None, :], Pinf).squeeze(-2)


def _rho_rows(rho, batch: int, dtype, device) -> torch.Tensor:
    rho = torch.as_tensor(rho).to(device=device, dtype=dtype).reshape(-1)
    return (rho.expand(batch) if rho.numel() == 1 else rho).contiguous()


def pad_hetero_problem(problem: Problem, cache: Cache,
                       dtype: Any = torch.float32) -> HeteroProblem:
    """Kernel operands from a batch-leading ``Problem``/``Cache`` (every
    field has a leading batch axis). Bounds are fully general: per instance
    and per knot. Runs where the tensors are."""
    f = lambda a: a.to(dtype)
    A = f(problem.A)
    Bn, nx = A.shape[0], A.shape[-1]
    nu = problem.B.shape[-1]
    N = problem.Xref.shape[-2]
    full = lambda a, knots, k: f(a).expand(Bn, knots, k).contiguous()
    Xref = full(problem.Xref, N, nx)
    with torch.no_grad():
        qc = -(Xref * f(problem.Q)[:, None, :])
        return HeteroProblem(
            A=A.contiguous(), B=f(problem.B).contiguous(),
            Kinf=f(cache.Kinf).contiguous(),
            Quu_inv=f(cache.Quu_inv).contiguous(),
            AmBKt=f(cache.AmBKt).contiguous(),
            u_min=full(problem.u_min, N - 1, nu),
            u_max=full(problem.u_max, N - 1, nu),
            x_min=full(problem.x_min, N, nx),
            x_max=full(problem.x_max, N, nx),
            qc=qc.contiguous(),
            pterm=_pterm(Xref, f(cache.Pinf)).contiguous(),
            rho=_rho_rows(cache.rho, Bn, dtype, A.device),
            dims=(nx, nu, N),
        )


def repack_hetero_caches(hp: HeteroProblem, cache: Cache,
                         Xref: torch.Tensor) -> HeteroProblem:
    """Replace only the cache-dependent operands (Kinf, Quu_inv, AmBKt,
    pterm, rho) after a per-instance cache/rho refresh -- the adaptive-rho
    loop's repack. ``cache`` batch-leading; ``Xref (B, N, nx)`` for pterm."""
    dt = hp.A.dtype
    f = lambda a: a.to(dt).contiguous()
    nx, _nu, N = hp.dims
    Xref = Xref.to(dt).expand(hp.batch, N, nx)
    with torch.no_grad():
        return hp.replace(
            Kinf=f(cache.Kinf), Quu_inv=f(cache.Quu_inv),
            AmBKt=f(cache.AmBKt), pterm=f(_pterm(Xref, cache.Pinf.to(dt))),
            rho=_rho_rows(cache.rho, hp.batch, dt, hp.A.device))


def pad_hetero_from_plants(
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho: torch.Tensor, problem: Problem, dtype: Any = torch.float32,
    riccati: str = "auto",
) -> tuple[HeteroProblem, Cache]:
    """On-device build for a batch of distinct plants: batched Riccati
    caches (reference math: src/tinympc/codegen.cpp:268-292) and the
    operands. ``A (B,nx,nx)``, ``B (B,nx,nu)``, ``Q/R`` raw cost diagonals,
    ``rho (B,)``; ``problem`` supplies batch-leading bounds and Xref.

    ``riccati`` routes the caches as the JAX package does: the fixed-point
    kernel K5 (:func:`.riccati_kernel.riccati_cache_kernel`) for
    ``"kernel"``, and for ``"auto"`` on CUDA tensors (any plant whose
    working set fits a block's shared memory; larger ones raise there); the
    batched tensor code :func:`..precompute.riccati_cache_jax` for
    ``"vmap"`` and for ``"auto"`` on the CPU."""
    from . import riccati_kernel as rk
    from ..precompute import riccati_cache_jax

    if riccati not in ("auto", "kernel", "vmap"):
        raise ValueError(f"riccati must be 'auto', 'kernel' or 'vmap', "
                         f"got {riccati!r}")
    if riccati == "kernel" or (riccati == "auto" and A.is_cuda):
        caches = rk.riccati_cache_kernel(A, B, Q, R, rho)
    else:
        caches = riccati_cache_jax(A, B, Q, R, rho)
    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    return pad_hetero_problem(prob_b, caches, dtype), caches


def _cone_groups(cones):
    return tuple(cones.input_cones), tuple(cones.state_cones)


def pad_hetero_cone_params(cones, batch: int, mu_u=None, shift_u=None,
                           mu_x=None, shift_x=None,
                           dtype: Any = torch.float32,
                           device: Any = None) -> torch.Tensor:
    """Per-instance cone parameters ``(B, n_cones, 2)``: ``[mu, shift]`` of
    every cone, input cones first. ``mu_u``/``shift_u`` are
    ``(n_input_cones, B)`` (None: the cones' static scalars), likewise
    ``mu_x``/``shift_x`` for the state cones."""
    ucones, xcones = _cone_groups(cones)
    if device is None:
        device = next((torch.as_tensor(a).device for a in
                       (mu_u, shift_u, mu_x, shift_x)
                       if isinstance(a, torch.Tensor)), "cpu")
    cols = []

    def push(group, mu, shift):
        for c, cone in enumerate(group):
            for given, static in ((mu, cone.mu), (shift, cone.shift)):
                if given is None:
                    cols.append(torch.full((batch,), float(static),
                                           dtype=dtype, device=device))
                else:
                    row = (given[c] if isinstance(given, torch.Tensor)
                           else torch.as_tensor(np.asarray(given[c])))
                    cols.append(row.to(device=device, dtype=dtype)
                                .reshape(batch))

    push(ucones, mu_u, shift_u)
    push(xcones, mu_x, shift_x)
    nc = len(ucones) + len(xcones)
    if not nc:
        raise ValueError("per-instance cone parameters without cones")
    return torch.stack(cols, dim=1).reshape(batch, nc, 2).contiguous()


def pad_hetero_cone_masks(cones, batch: int, nx: int, nu: int, ball_u=None,
                          axis_u=None, ball_x=None, axis_x=None,
                          dtype: Any = torch.float32,
                          device: Any = "cpu") -> torch.Tensor:
    """Per-instance cone geometry ``(B, MR)``: per cone its ball mask then
    its axis one-hot, ``dim`` floats each (``nu`` for input cones, first;
    ``nx`` for state cones). ``ball_u[c]`` is ``(B, nu)`` 0/1 membership
    (None: the cone's static ball), ``axis_u[c]`` ``(B,)`` int axis indices
    (None: the static axis); likewise on ``nx``. Where the masks encode a
    cone's static indices, the masked projection equals the static one.

    Validated here (the masked projection's arithmetic corrupts otherwise):
    axis indices in ``[0, dim)``, and each instance's effective ball and
    axis entries disjoint -- the trap is overriding only ``axis`` while the
    static ball still covers the new axis coordinate."""
    ucones, xcones = _cone_groups(cones)
    blocks = []

    def push(group, dim, ball, axis, kind):
        for c, cone in enumerate(group):
            bm = np.zeros((batch, dim), np.float32)
            if ball is None or ball[c] is None:
                bm[:, list(cone.ball)] = 1.0
            else:
                bm[:, :] = np.asarray(ball[c], np.float32)
            am = np.zeros((batch, dim), np.float32)
            if axis is None or axis[c] is None:
                am[:, int(cone.axis)] = 1.0
            else:
                ax = np.asarray(axis[c], np.int64)
                if ax.min() < 0 or ax.max() >= dim:
                    raise ValueError(
                        f"{kind} cone {c}: axis indices must be in "
                        f"[0, {dim}), got [{ax.min()}, {ax.max()}]")
                am[np.arange(batch), ax] = 1.0
            bad = np.nonzero((bm * am).sum(axis=1) > 0)[0]
            if bad.size:
                raise ValueError(
                    f"{kind} cone {c}: ball and axis lanes overlap for "
                    f"instance(s) {bad[:8].tolist()}"
                    f"{'...' if bad.size > 8 else ''} -- when overriding "
                    "only axis (or only ball), the other defaults to the "
                    "cone's static indices; pass both")
            blocks.extend((bm, am))

    push(ucones, nu, ball_u, axis_u, "input")
    push(xcones, nx, ball_x, axis_x, "state")
    if not blocks:
        raise ValueError("per-instance cone masks without cones")
    return torch.as_tensor(np.concatenate(blocks, axis=1)).to(
        device=device, dtype=dtype).contiguous()


def gather_hetero(hp: HeteroProblem, carry: HeteroCarry, x0: torch.Tensor,
                  idx: torch.Tensor, cone_params=None, cone_masks=None):
    """Instances ``idx`` of a problem, its carry, x0 and the per-instance
    cone operands -- the compaction primitive of
    :func:`..solver.cascade.hetero_cascade_solve`. Returns
    ``(hp, carry, x0, cone_params, cone_masks)`` (the cone operands None
    where not given)."""
    take = lambda a: None if a is None else a.index_select(0, idx)
    hp2 = HeteroProblem(**{k: take(v) for k, v in hp.tensors().items()},
                        dims=hp.dims)
    return (hp2, HeteroCarry(*(take(a) for a in carry)), take(x0),
            take(cone_params), take(cone_masks))


# ----------------------------------------------------------- plain version --

def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product per instance: (B, r, c) x (B, c) -> (B, r);
    a shared (r, c) matrix multiplies every row of ``v``."""
    if M.dim() == 2:
        return torch.matmul(v, M.transpose(-1, -2))
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _per_row(rho: torch.Tensor, dims: int) -> torch.Tensor:
    """A per-instance ``(B,)`` penalty shaped to broadcast over ``dims``
    trailing axes; a shared scalar as it is."""
    return rho if rho.dim() == 0 else rho.reshape((-1,) + (1,) * dims)


def _cone_fn(group, dim: int, first: int, moff: int, cone_params,
             cone_masks):
    """The projection of slacks ``W (B, K, dim)`` onto each cone of
    ``group`` in order; per-instance parameters/geometry where given."""
    from ..solver.cones import project_cone, project_cone_masked

    if not group:
        return None

    def apply(W):
        off = moff
        for c, cone in enumerate(group):
            mu = shift = bm = am = None
            if cone_params is not None:
                mu = cone_params[:, first + c, 0]
                shift = cone_params[:, first + c, 1]
            if cone_masks is not None:
                bm = cone_masks[:, off:off + dim]
                am = cone_masks[:, off + dim:off + 2 * dim]
                off += 2 * dim
            if mu is None and bm is None:
                W = project_cone(W, cone)
            else:
                W = project_cone_masked(W, cone, ball_mask=bm, axis_mask=am,
                                        mu=mu, shift=shift)
        return W

    return apply


def _clip(S, lo, hi):
    return torch.minimum(torch.maximum(S, lo), hi)


def _iteration(x0, D, Y, G, hp: HeteroProblem, en_ib, en_sb, cone_u,
               cone_x):
    """One ADMM iteration per instance (reference: src/tinympc/
    admm.cpp:117-150; stage order of the JAX ``_make_iteration``)."""
    nx, nu, N = hp.dims
    m = N - 1
    xs, us = [x0], []
    for i in range(m):
        u = -_mv(hp.Kinf, xs[i]) - D[:, i]
        us.append(u)
        xs.append(_mv(hp.A, xs[i]) + _mv(hp.B, u))
    U = torch.stack(us, dim=1)
    X = torch.stack(xs, dim=1)
    Su = U + Y
    Znew = _clip(Su, hp.u_min, hp.u_max) if en_ib else Su
    if cone_u is not None:
        Znew = cone_u(Znew)
    Tx = X + G
    Vnew = _clip(Tx, hp.x_min, hp.x_max) if en_sb else Tx
    if cone_x is not None:
        Vnew = cone_x(Vnew)
    Ynew = Su - Znew
    Gnew = Tx - Vnew
    rho3 = _per_row(hp.rho, 2)
    Rf = -rho3 * (Znew - Ynew)
    Qf = hp.qc - rho3 * (Vnew - Gnew)
    p = hp.pterm - _per_row(hp.rho, 1) * (Vnew[:, -1] - Gnew[:, -1])
    Bt = hp.B.transpose(-1, -2)
    Kt = hp.Kinf.transpose(-1, -2)
    ds = [None] * m
    for i in reversed(range(m)):
        r = Rf[:, i]
        ds[i] = _mv(hp.Quu_inv, _mv(Bt, p) + r)
        if i:
            p = Qf[:, i] + _mv(hp.AmBKt, p) - _mv(Kt, r)
    return torch.stack(ds, dim=1), Ynew, Gnew, Znew, Vnew, U, X


def _amax(a):
    return a.abs().amax(dim=(1, 2))


def _check_cone_args(cones, cone_params, cone_masks):
    if (cone_params is not None or cone_masks is not None) and cones is None:
        raise ValueError("cone_params/cone_masks without cones")


def hetero_solve_plain(
    x0: torch.Tensor, carry: HeteroCarry, hp: HeteroProblem, *,
    max_iter: int = 100, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    en_input_bound: bool = True, en_state_bound: bool = True,
    cones=None, cone_params=None, cone_masks=None,
) -> HeteroResult:
    """Plain PyTorch version of :func:`hetero_solve` (which see): the
    kernels' arithmetic on whole-batch tensors, on any device and in float32
    or float64. ``hp`` may also be a shared-plant operand set (2-D
    matrices, a scalar ``rho``, bounds and ``qc`` without the batch axis or
    with a single knot row): the stream tier's plain version runs here."""
    _check_cone_args(cones, cone_params, cone_masks)
    nx, nu, N = hp.dims
    cone_u = cone_x = None
    if cones is not None:
        ucones, xcones = _cone_groups(cones)
        cone_u = _cone_fn(ucones, nu, 0, 0, cone_params, cone_masks)
        cone_x = _cone_fn(xcones, nx, len(ucones), 2 * nu * len(ucones),
                          cone_params, cone_masks)
    x0 = x0.to(hp.A.dtype)
    step = lambda D, Y, G: _iteration(
        x0, D, Y, G, hp, en_input_bound, en_state_bound, cone_u, cone_x)
    rho = hp.rho
    Bn = x0.shape[0]
    stats = torch.zeros((Bn, 8), dtype=hp.A.dtype, device=x0.device)
    with torch.no_grad():
        if check_termination <= 0:
            D, Y, G, Zp, Vp = carry.d, carry.y, carry.g, carry.z, carry.v
            if max_iter <= 0:
                Z, V = Zp, Vp
                U, X = torch.zeros_like(Zp), torch.zeros_like(Vp)
            else:
                for _ in range(max_iter - 1):
                    D, Y, G, Zp, Vp, _U, _X = step(D, Y, G)
                D, Y, G, Z, V, U, X = step(D, Y, G)
            stats[:, 0] = float(max(max_iter, 0))
            stats[:, 2] = _amax(X - V)
            stats[:, 3] = rho * _amax(Vp - V)
            stats[:, 4] = _amax(U - Z)
            stats[:, 5] = rho * _amax(Zp - Z)
            return HeteroResult(HeteroCarry(D, Y, G, Z, V), U, X, stats)

        if max_iter < 1:
            raise ValueError("adaptive hetero solve needs max_iter >= 1")
        D, Y, G, Z, V = carry.d, carry.y, carry.g, carry.z, carry.v
        U, X = torch.zeros_like(Z), torch.zeros_like(V)
        done = torch.zeros((Bn,), dtype=torch.bool, device=x0.device)
        iters = torch.full((Bn,), float(max_iter), dtype=stats.dtype,
                           device=x0.device)
        col = lambda msk: msk[:, None, None]
        for kc in range(1, max_iter + 1):
            Dn, Yn, Gn, Zn, Vn, Un, Xn = step(D, Y, G)
            live = ~done
            newly = torch.zeros_like(done)
            if kc % check_termination == 0:
                res = torch.stack([_amax(Xn - Vn), rho * _amax(V - Vn),
                                   _amax(Un - Zn), rho * _amax(Z - Zn)], 1)
                stats[:, 2:6] = torch.where(live[:, None], res,
                                            stats[:, 2:6])
                newly = live & (res[:, 0] < abs_pri_tol) \
                    & (res[:, 2] < abs_pri_tol) & (res[:, 1] < abs_dua_tol) \
                    & (res[:, 3] < abs_dua_tol)
                iters = torch.where(newly, torch.full_like(iters, kc), iters)
            cont = live & ~newly
            U = torch.where(col(live), Un, U)
            X = torch.where(col(live), Xn, X)
            Y = torch.where(col(live), Yn, Y)
            G = torch.where(col(live), Gn, G)
            D = torch.where(col(cont), Dn, D)
            Z = torch.where(col(cont), Zn, Z)
            V = torch.where(col(cont), Vn, V)
            done = done | newly
            if bool(done.all()):
                break
        stats[:, 0] = iters
        stats[:, 1] = done.to(stats.dtype)
        return HeteroResult(HeteroCarry(D, Y, G, Z, V), U, X, stats)


# ------------------------------------------------------------------ kernel --

_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("hetero_admm")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_hetero_solve.argtypes = (
            [_P] * 27 + [_I] * 2 + [_P] * 3 + [_I] * 8 + [_F] * 2 + [_I] * 2
            + [_P])
        lib.atm_hetero_solve.restype = _I
        lib.atm_hetero_resident.argtypes = [_I] * 6
        lib.atm_hetero_resident.restype = _I
        lib._atm_declared = True
    return lib


def _r4(n: int) -> int:
    return (n + 3) & ~3


def group_size(nx: int, nu: int) -> int:
    """Lanes per instance in the kernels: the power of two >= nx + nu, from
    4 to 32 (lane j owns rows j, j + G, ... of the nx state rows, then the nu
    input rows)."""
    g = 4
    while g < nx + nu and g < 32:
        g *= 2
    return g


def inst_floats(nx: int, nu: int, N: int, nc: int,
                adaptive: bool = True) -> int:
    """Shared-memory floats one instance needs (mirrors ``make_layout`` in
    ``csrc/hetero_admm.cu``; the C entry refuses a launch when the two
    disagree): p|w double-buffered and pterm (padded to 4); per knot a
    record of stacked rows (x|u, the slacks v|z (two rows in the adaptive
    kernel), the duals g|y, the bounds, qc|d), each ``nx + nu`` floats,
    padded to a multiple of 4 for a compiled shape; mu, shift and a role
    per stacked row for each cone; for the run-time body the rows of [A;
    Kinf] and [AmBKt; B'] (nx wide), of B, Kinf' and Quu_inv. Rounded up
    to a multiple of 4."""
    compiled = (nx, nu) in HETERO_SHAPES
    R = _r4(nx + nu) if compiled else nx + nu
    records = N * (6 + bool(adaptive)) * R
    rows = 0 if compiled else 2 * R * nx + 2 * nx * nu + nu * nu
    return _r4(2 * R + _r4(nx) + records + (2 + R) * nc + rows)


def inst_stride(floats: int, G: int) -> int:
    """The floats between two instances' slices (mirrors ``inst_stride`` in
    ``csrc/hetero_admm.cu``): ``floats`` padded so that the groups of a warp
    (G < 32 lanes each) start on different shared-memory banks."""
    return floats + (G - floats % 32) % 32 if G < 32 else floats


def hetero_plan(nx: int, nu: int, N: int, nc: int = 0,
                adaptive: bool = True,
                limit: int = SMEM_LIMIT_BYTES) -> dict:
    """The launch of the hetero kernels (K7/K8) for these sizes: ``kernel``
    (``"compiled nx/nu"`` for ``HETERO_SHAPES``, else ``"run-time"``), ``G``
    (lanes per instance, :func:`group_size`), ``rows_per_lane``
    (``ceil((nx + nu) / G)``), ``threads`` and ``instances_per_block``,
    ``smem_bytes`` per block and ``bytes_per_instance`` (an instance's
    slice, :func:`inst_floats` padded by :func:`inst_stride`). Where a block of
    128 threads does not fit, fewer instances share a block. Raises where
    one instance does not fit, naming the bytes and the tier that runs any
    size."""
    G = group_size(nx, nu)
    rows_per_lane = -(-(nx + nu) // G)
    per = 4 * inst_stride(inst_floats(nx, nu, N, nc, adaptive), G)
    threads = THREADS
    while threads // G * per > limit and threads > max(32, G):
        threads //= 2
    if threads // G * per > limit or rows_per_lane > ROWS_MAX:
        raise ValueError(
            f"the hetero kernels' knots and rows for nx={nx}, nu={nu}, "
            f"horizon={N}, {nc} cones need {threads // G * per} bytes of "
            f"shared memory per block (limit {limit}): use "
            f"tier=\"instance_ops\", which runs any size")
    return {"kernel": (f"compiled {nx}/{nu}" if (nx, nu) in HETERO_SHAPES
                       else "run-time"),
            "G": G, "rows_per_lane": rows_per_lane, "threads": threads,
            "instances_per_block": threads // G,
            "smem_bytes": threads // G * per, "bytes_per_instance": per}


def hetero_resident(nx: int, nu: int, N: int, nc: int = 0,
                    adaptive: bool = True, device: Any = "cuda") -> int:
    """Blocks of the hetero kernel :func:`hetero_plan` picks that one SM
    holds at once (the CUDA occupancy query). The kernels launch that many
    blocks an SM at most (persistent blocks), so a batch past
    ``this x SMs x instances_per_block`` slots refills them from the work
    counter."""
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    plan = hetero_plan(nx, nu, N, nc, adaptive, limit)
    with torch.cuda.device(dev):
        n = _library().atm_hetero_resident(nx, nu, N, nc, int(bool(adaptive)),
                                           plan["threads"])
    if n < 1:
        raise RuntimeError(f"hetero_resident: the occupancy query failed "
                           f"({n})")
    return n


def hetero_slots(nx: int, nu: int, N: int, nc: int = 0,
                 adaptive: bool = True, device: Any = "cuda") -> int:
    """Instances the card holds at once for a launch of these sizes; a batch
    past it refills the slots (``batch - this`` refills)."""
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = hetero_plan(nx, nu, N, nc, adaptive)
    return (hetero_resident(nx, nu, N, nc, adaptive, dev) * n_sm
            * plan["instances_per_block"])


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """The operand as the kernels read it: on ``device``, float32, of
    ``shape``, contiguous and 16-byte aligned (a view off a 16-byte
    boundary is copied)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}: the CUDA kernels are float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _cone_table(cones, nx: int, nu: int, device):
    """The kernels' static cone table on ``device``: per cone (input cones
    first) a float32 row of ``2 + max(nx, nu)``: ``mu, shift``, then the role
    of each component of its knot (1 in the ball, 2 the axis, 0 neither;
    ``group_ops.cuh`` ``load_cones``). Returns ``(table, nc_u, nc_x)``,
    ``(None, 0, 0)`` without cones. Raises on indices outside a knot or an
    axis inside its ball."""
    if cones is None:
        return None, 0, 0
    ucones, xcones = _cone_groups(cones)
    if not (ucones or xcones):
        return None, 0, 0
    width = max(nx, nu)
    rows = np.zeros((len(ucones) + len(xcones), 2 + width), np.float32)
    for k, cone in enumerate(ucones + xcones):
        dim = nu if k < len(ucones) else nx
        ball = [int(b) for b in cone.ball]
        if any(not 0 <= i < dim for i in ball + [int(cone.axis)]):
            raise ValueError(f"cone {k}: indices must be in [0, {dim})")
        if int(cone.axis) in ball:
            raise ValueError(f"cone {k}: axis is in the ball")
        rows[k, :2] = float(cone.mu), float(cone.shift)
        rows[k, 2 + np.asarray(ball, int)] = 1.0
        rows[k, 2 + int(cone.axis)] = 2.0
    return (torch.as_tensor(rows, device=device), len(ucones), len(xcones))


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(
            f"{what}: launch refused (sizes out of range, or the wrapper's "
            "and the kernel's shared-memory layouts disagree)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def hetero_solve(
    x0: torch.Tensor,
    carry: HeteroCarry,
    hp: HeteroProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    en_input_bound: bool = True,
    en_state_bound: bool = True,
    cones=None,
    cone_params: torch.Tensor | None = None,
    cone_masks: torch.Tensor | None = None,
) -> HeteroResult:
    """Batched ADMM, one distinct plant per instance.

    ``x0 (B, nx)``; per instance the semantics of :func:`..solver.admm.solve`
    (reference: src/tinympc/admm.cpp:111-152). ``check_termination == 0``
    runs the fixed-iteration kernel (K7), ``> 0`` the adaptive kernel (K8)
    with per-instance convergence freezing every that many iterations (stats
    column 1 the solved flag, column 0 the iterations). Tolerances are
    runtime arguments. ``cones``/``cone_params``/``cone_masks`` as in the
    module docstring. Returns the final iterates, a warm-start carry and the
    per-instance residual stats.

    Tensors on the CPU go through :func:`hetero_solve_plain`; tensors on a
    CUDA device launch the kernel (float32, any size whose instance fits a
    block's shared memory: :func:`hetero_plan`) or raise.
    """
    _check_cone_args(cones, cone_params, cone_masks)
    adaptive = check_termination > 0
    if adaptive and max_iter < 1:
        raise ValueError("adaptive hetero solve needs max_iter >= 1")
    if not x0.is_cuda:
        return check_outputs(hetero_solve_plain(
            x0, carry, hp, max_iter=max_iter,
            check_termination=check_termination, abs_pri_tol=abs_pri_tol,
            abs_dua_tol=abs_dua_tol, en_input_bound=en_input_bound,
            en_state_bound=en_state_bound, cones=cones,
            cone_params=cone_params, cone_masks=cone_masks), "hetero_solve")

    nx, nu, N = hp.dims
    m = N - 1
    Bn = x0.shape[0]
    dev = x0.device
    ctab, nc_u, nc_x = _cone_table(cones, nx, nu, dev)
    nc = nc_u + nc_x
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    plan = hetero_plan(nx, nu, N, nc, adaptive, limit)
    c = lambda name, t, shape: _check(name, t, shape, dev)
    ops = [
        c("x0", x0, (Bn, nx)), c("hp.A", hp.A, (Bn, nx, nx)),
        c("hp.B", hp.B, (Bn, nx, nu)), c("hp.Kinf", hp.Kinf, (Bn, nu, nx)),
        c("hp.Quu_inv", hp.Quu_inv, (Bn, nu, nu)),
        c("hp.AmBKt", hp.AmBKt, (Bn, nx, nx)),
        c("hp.u_min", hp.u_min, (Bn, m, nu)),
        c("hp.u_max", hp.u_max, (Bn, m, nu)),
        c("hp.x_min", hp.x_min, (Bn, N, nx)),
        c("hp.x_max", hp.x_max, (Bn, N, nx)),
        c("hp.qc", hp.qc, (Bn, N, nx)), c("hp.pterm", hp.pterm, (Bn, nx)),
        c("hp.rho", hp.rho, (Bn,)),
        c("carry.d", carry.d, (Bn, m, nu)), c("carry.y", carry.y, (Bn, m, nu)),
        c("carry.g", carry.g, (Bn, N, nx)), c("carry.z", carry.z, (Bn, m, nu)),
        c("carry.v", carry.v, (Bn, N, nx)),
    ]
    if cone_params is not None:
        cone_params = c("cone_params", cone_params, (Bn, nc, 2))
    if cone_masks is not None:
        mr = 2 * nu * len(cones.input_cones) + 2 * nx * len(cones.state_cones)
        cone_masks = c("cone_masks", cone_masks, (Bn, mr))
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    U, X = new(Bn, m, nu), new(Bn, N, nx)
    d, y, g, z, v = (new(Bn, m, nu), new(Bn, m, nu), new(Bn, N, nx),
                     new(Bn, m, nu), new(Bn, N, nx))
    stats = new(Bn, 8)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.atm_hetero_solve(
            *(t.data_ptr() for t in ops),
            U.data_ptr(), X.data_ptr(), d.data_ptr(), y.data_ptr(),
            g.data_ptr(), z.data_ptr(), v.data_ptr(), stats.data_ptr(),
            None if ctab is None else ctab.data_ptr(), nc_u, nc_x,
            None if cone_params is None else cone_params.data_ptr(),
            None if cone_masks is None else cone_masks.data_ptr(),
            counter.data_ptr(), Bn, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            int(bool(en_input_bound)), int(bool(en_state_bound)),
            float(abs_pri_tol), float(abs_dua_tol), plan["threads"],
            plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "hetero_solve")
    LAUNCH_COUNTS["hetero_solve_adaptive" if adaptive
                  else "hetero_solve_fixed"] += 1
    return check_outputs(HeteroResult(
        HeteroCarry(d=d, y=y, g=g, z=z, v=v), U, X, stats), "hetero_solve")
