"""Fused ADMM solve: the entire batched solve in one CUDA kernel launch.

Counterpart of the JAX package's ``ops/fused_admm.py``. The condensed
formulation (:mod:`..solver.condensed`) turns each ADMM iteration into a
handful of small products plus elementwise chains; as separate tensor ops
every ``(B, .)`` intermediate goes through device memory once per
iteration. Here the whole solve loop runs inside one kernel
(``csrc/fused_admm.cu``): the operators and the iterates of one slot per
instance in flight stay in a block's shared memory for all iterations (a
slot takes the next instance from a work counter when its own one is done),
so device memory is read once and written once per *solve*. Where the
operators do not fit beside one register tile of slots (the quadrotor past
N=18), the kernels read them from device memory instead, in the padded
layout of :func:`pad_problem` (:func:`choose_placement`); the sums run in
the same order, so both placements give the same bits. Where one register
tile of 8 slots' state does not fit even then (the quadrotor past N=78),
the register tiles hold 4 slots (:func:`choose_register_tile`), again with
the same bits; the quadrotor then runs to N=150, past the JAX package's
N=129. The fixed box-only float32 solve (K1) runs on a body of its own
(``csrc/fixed_waves.cuh``: waves of slots in lockstep, each thread's
duals, slacks and x0 terms in its registers) wherever :func:`fixed_path`
says so, at the same geometry and to the same bits.

Semantics: stage for stage the reference iteration (reference:
src/tinympc/admm.cpp:111-152) in a fixed-iteration mode and an adaptive mode
with per-instance early exit (residuals per admm.cpp:91-109; the exit skips
the slack save and the backward pass, admm.cpp:135-144).

**Folded iteration.** With ``Q = xref_q - rho (Vnew - Gn)``,
``R = -rho (Znew - Yn)`` and the terminal costate refresh, the condensed
backward output is ``Dn = (Vnew-Gn) @ W_q + (Znew-Yn) @ W_r + const_d`` where
``W_q = -rho [Eq^T; Ep^T]``, ``W_r = -rho Er^T`` are baked on the host in
float64 and ``const_d = xref_q @ W_eq + pterm_c @ W_ep`` depends on the
reference but not on the iteration, so it is hoisted out of the loop.

**Layout.** Unpadded and one instance per row: ``D, Y, Z, U (B, Du)``,
``G, V, X (B, Dx)`` with ``Du = (N-1) nu``, ``Dx = N nx``; ``stats (B, 6)``
= iterations, solved, pri_state, dua_state, pri_input, dua_input. The
kernel sees the two spaces concatenated, ``z = [x | u]``.

**Second-order cones.** ``cone_ops`` (from :func:`pad_cones`) appends exact
cone projections to the slack stage, after the box clip and in the cones'
order, exactly as the scan tier's ``cone_slack_update``
(:mod:`..solver.cones`). On the card they run inside the coned
instantiations of the three kernels, in the forward stage's pass, each
warp over whole knots (``cone_forward_stage`` in
``csrc/admm_iteration.cuh``; the layout from :func:`cone_items`); the
split-bf16 kernels project in a pass of their own, one thread per
(instance, knot) (``cone_stage``).

Beside the kernel sits :func:`fused_solve_plain`, batched tensor code that
repeats the kernel's arithmetic stage by stage. :func:`fused_solve` takes it
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ..precompute import CondensedOperators
from ..types import DEFAULT_DEVICE, Cache, Problem, _Struct
from ..utils.debugging import check_outputs

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products

# Launches per kernel, counted where (and only where) a wrapper launches it.
LAUNCH_COUNTS = {
    "fused_solve_fixed": 0,
    "fused_solve_adaptive": 0,
    "fused_rollout": 0,        # adaptive tick solves
    "fused_rollout_fixed": 0,  # fixed tick solves (check_termination = 0)
    # the coned instantiations (cone_ops given)
    "fused_solve_fixed_cones": 0,
    "fused_solve_adaptive_cones": 0,
    "fused_rollout_cones": 0,
    "fused_rollout_fixed_cones": 0,
    # the split-bf16 kernels (algo="bf16x3"), the same eight
    "fused_solve_fixed_bf16x3": 0,
    "fused_solve_adaptive_bf16x3": 0,
    "fused_rollout_bf16x3": 0,
    "fused_rollout_fixed_bf16x3": 0,
    "fused_solve_fixed_cones_bf16x3": 0,
    "fused_solve_adaptive_cones_bf16x3": 0,
    "fused_rollout_cones_bf16x3": 0,
    "fused_rollout_fixed_cones_bf16x3": 0,
}


def kernel_name(base: str, coned: bool, algo: str) -> str:
    """The :data:`LAUNCH_COUNTS` key of a launch: ``base`` (e.g.
    ``"fused_solve_fixed"``), then ``_cones`` and ``_bf16x3``."""
    return base + ("_cones" if coned else "") + (
        "_bf16x3" if algo == "bf16x3" else "")

# Kernel geometry. Slots per block are a multiple of the register tile (8
# slots; 4 where one tile of 8 slots' state does not fit even with the
# operators in device memory); the shared-memory budget is the 227 KB a
# Hopper block may take. Threads per block follow the tile (16 per slot, at
# most 256): the best pairs of tools/torch_kernel_sweep.py's table on an
# H100; the 4-slot tile, whose products are long, takes 256.
REGISTER_TILE = 8
REGISTER_TILES = (8, 4)
MAX_TILE = 64
MAX_THREADS = 256
THREADS_PER_INSTANCE = 16
SMEM_LIMIT_BYTES = 232_448
# Where the kernels keep the condensed operators (choose_placement).
PLACEMENTS = ("shared", "device")


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class PaddedProblem(_Struct):
    """Condensed operators + problem vectors, kernel-ready.

    All ``W_*`` are stored transposed, ``(in, out)``, so every contraction is
    ``Y = X @ W``. ``W_eq_u``/``W_ep_u`` are used only outside the kernel to
    fold the reference vectors into ``const_d``. ``W_x``, ``W_f``, ``W_b``,
    ``lo``, ``hi`` are the kernel's operands: the same data concatenated over
    ``z = [x | u]``, the three matrices padded with zero rows and columns to
    multiples of 4 (``DuP = r4(Du)``, ``DzP = r4(Dz)``: the float4 rows the
    kernels read, in shared memory or in place in device memory).
    """

    W_fx: torch.Tensor    # (nx, Dx)  x0 -> X
    W_fd: torch.Tensor    # (Du, Dx)  D  -> X
    W_gx: torch.Tensor    # (nx, Du)  x0 -> U
    W_gd: torch.Tensor    # (Du, Du)  D  -> U
    W_q: torch.Tensor     # (Dx, Du)  (Vnew-Gn) -> D   [-rho folded]
    W_r: torch.Tensor     # (Du, Du)  (Znew-Yn) -> D   [-rho folded]
    W_eq_u: torch.Tensor  # (Dx, Du)  Eq^T (zero terminal rows)
    W_ep_u: torch.Tensor  # (Dx, Du)  Ep^T at the terminal rows
    xref_q: torch.Tensor  # (1, Dx) = -(Xref * Qdiag)
    pterm_c: torch.Tensor  # (1, Dx) = -Xref[-1] @ Pinf in the terminal knot
    u_min: torch.Tensor   # (1, Du)
    u_max: torch.Tensor
    x_min: torch.Tensor   # (1, Dx)
    x_max: torch.Tensor
    rho: torch.Tensor     # scalar
    W_x: torch.Tensor     # (nx, DzP) = [W_fx | W_gx], zero padded
    W_f: torch.Tensor     # (DuP, DzP) = [W_fd | W_gd], zero padded
    W_b: torch.Tensor     # (DzP, DuP) = [W_q ; W_r], zero padded
    lo: torch.Tensor      # (Dz,)    = [x_min | u_min]
    hi: torch.Tensor      # (Dz,)
    dims: tuple = ()      # (nx, nu, horizon)
    rho_f: float = 1.0    # rho as a host float (a kernel argument)

    @property
    def Dx(self) -> int:
        nx, _nu, N = self.dims
        return N * nx

    @property
    def Du(self) -> int:
        _nx, nu, N = self.dims
        return (N - 1) * nu


def _np64(a) -> np.ndarray:
    return np.asarray(a.detach().cpu().numpy(), np.float64)


def pad_problem(
    problem: Problem, cache: Cache, ops: CondensedOperators,
    dtype: Any = torch.float32, device: Any = DEFAULT_DEVICE,
) -> PaddedProblem:
    """Build the kernel operands (host-side, float64 until the final cast)."""
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    Dx = N * nx
    t0 = Dx - nx  # first terminal-knot column

    o = {k: _np64(getattr(ops, k)) for k in ops._fields}
    rho_f = float(_np64(cache.rho))
    Xref = _np64(problem.Xref)

    # Backward operator with the terminal-costate rows folded in (reference:
    # admm.cpp:15-22 backward sweep + admm.cpp:83-84 terminal costate
    # refresh -- both rho-scaled linear-cost contractions).
    W_q = -rho_f * np.vstack([o["Eq"].T, o["Ep"].T])   # (Dx, Du)
    W_r = -rho_f * o["Er"].T
    W_eq_u = np.vstack([o["Eq"].T, np.zeros((nx, o["Eq"].shape[0]))])
    W_ep_u = np.zeros_like(W_eq_u)
    W_ep_u[t0:] = o["Ep"].T
    pterm = np.zeros(Dx)
    pterm[t0:] = -Xref[-1] @ _np64(cache.Pinf)
    W_fx, W_fd = o["Fx0"].T, o["Fd"].T
    W_gx, W_gd = o["Gx0"].T, o["Gd"].T
    flat = lambda a: _np64(a).reshape(1, -1)
    u_min, u_max = flat(problem.u_min), flat(problem.u_max)
    x_min, x_max = flat(problem.x_min), flat(problem.x_max)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    r4 = lambda n: (n + 3) & ~3

    def padded(W, rows):   # zero rows and columns up to (rows, r4(cols))
        out = np.zeros((rows, r4(W.shape[1])))
        out[:W.shape[0], :W.shape[1]] = W
        return out

    return PaddedProblem(
        W_fx=t(W_fx), W_fd=t(W_fd), W_gx=t(W_gx), W_gd=t(W_gd),
        W_q=t(W_q), W_r=t(W_r), W_eq_u=t(W_eq_u), W_ep_u=t(W_ep_u),
        xref_q=t(-(Xref * _np64(problem.Q)).reshape(1, -1)),
        pterm_c=t(pterm.reshape(1, -1)),
        u_min=t(u_min), u_max=t(u_max), x_min=t(x_min), x_max=t(x_max),
        rho=t(rho_f),
        W_x=t(padded(np.hstack([W_fx, W_gx]), nx)),
        W_f=t(padded(np.hstack([W_fd, W_gd]), r4(W_fd.shape[0]))),
        W_b=t(padded(np.vstack([W_q, W_r]), r4(Dx + W_r.shape[0]))),
        lo=t(np.hstack([x_min, u_min]).reshape(-1)),
        hi=t(np.hstack([x_max, u_max]).reshape(-1)),
        dims=(nx, nu, N),
        rho_f=rho_f,
    )


def ref_vectors(
    pp: PaddedProblem, Q: torch.Tensor, Pinf: torch.Tensor,
    Xref: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference-dependent operands for a new horizon window (tracking
    mode, reference: quadrotor_tracking.cpp:101 sliding the window each
    tick): the baked ``xref_q``/``pterm_c`` of :func:`pad_problem` are just
    these two vectors, so updating the reference costs two tiny tensor ops
    (``const_d`` is folded from them inside :func:`fused_solve`).

    ``Q`` is the (nx,) workspace cost diagonal, ``Pinf`` the (nx, nx) cache
    matrix, ``Xref`` the (N, nx) window. Returns ``(xref_q, pterm_c)`` shaped
    ``(1, Dx)``.
    """
    nx, _nu, N = pp.dims
    dtype, device = pp.xref_q.dtype, pp.xref_q.device
    Xref = torch.as_tensor(Xref, dtype=dtype, device=device)
    xref_q = -(Xref * Q).reshape(1, -1)
    pterm_c = torch.zeros((1, N * nx), dtype=dtype, device=device)
    pterm_c[0, (N - 1) * nx:] = -torch.matmul(Xref[-1], Pinf)
    return xref_q, pterm_c


def fold_const_d(pp: PaddedProblem, xref_q=None, pterm_c=None) -> torch.Tensor:
    """``const_d = xref_q @ W_eq + pterm_c @ W_ep`` -- the iteration-invariant
    part of the folded linear-cost/backward stage. Shape ``(rows, Du)``."""
    xq = pp.xref_q if xref_q is None else xref_q
    pc = pp.pterm_c if pterm_c is None else pterm_c
    return torch.matmul(xq, pp.W_eq_u) + torch.matmul(pc, pp.W_ep_u)


@dataclasses.dataclass(frozen=True)
class FusedConeOps(_Struct):
    """Second-order-cone operands of the fused tier (built by
    :func:`pad_cones`; see :mod:`..solver.cones` for the cone model and the
    closed-form projection). Per cone the kernel needs the ball indices and
    the axis index inside a knot, ``mu`` and ``shift``: input cones first,
    then state cones, any number of each with balls of any size. ``idx`` /
    ``par`` are the host values (``[nc_u, nc_x, then per cone nball, axis,
    ball[nball]]`` and ``[mu, shift]`` per cone); ``table`` / ``params`` the
    kernels' copy on the device (per cone the offset of its row, then the
    rows ``[nball, axis, ball]``; ``par``); ``mu``/``shift`` the same values
    on the device, the defaults of the per-instance rows."""

    mu: torch.Tensor      # (nc_u + nc_x,)
    shift: torch.Tensor   # (nc_u + nc_x,)
    table: torch.Tensor = None   # int32, see above
    params: torch.Tensor = None  # (2 (nc_u + nc_x),) float32
    cones: Any = None     # the ConeSet
    idx: tuple = ()
    par: tuple = ()
    nc_u: int = 0
    nc_x: int = 0


def pad_cones(pp: PaddedProblem, cones) -> FusedConeOps:
    """Build :class:`FusedConeOps` for a :class:`..solver.cones.ConeSet` on
    ``pp``'s problem. Raises if a cone indexes outside its knot or if ball
    and axis overlap; the number of cones and of ball entries is free."""
    nx, nu, _N = pp.dims
    ucones, xcones = tuple(cones.input_cones), tuple(cones.state_cones)
    idx = [len(ucones), len(xcones)]
    rows, par = [], []
    for kind, dim, group in (("input", nu, ucones), ("state", nx, xcones)):
        for c, cone in enumerate(group):
            ball = [int(b) for b in cone.ball]
            axis = int(cone.axis)
            if any(not 0 <= b < dim for b in ball + [axis]):
                raise ValueError(
                    f"{kind} cone {c}: indices must be in [0, {dim})")
            if axis in ball:
                raise ValueError(f"{kind} cone {c}: axis is in the ball")
            rows.append([len(ball), axis] + ball)
            par += [float(cone.mu), float(cone.shift)]
    idx += [v for row in rows for v in row]
    table, off = [], len(rows)
    for row in rows:
        table.append(off)
        off += len(row)
    table += idx[2:]
    dtype, device = pp.lo.dtype, pp.lo.device
    vals = torch.tensor(par, dtype=torch.float64).reshape(-1, 2)
    return FusedConeOps(
        mu=vals[:, 0].to(device=device, dtype=dtype),
        shift=vals[:, 1].to(device=device, dtype=dtype),
        table=torch.tensor(table, dtype=torch.int32, device=device),
        params=torch.tensor(par, dtype=torch.float32, device=device),
        cones=cones, idx=tuple(idx), par=tuple(par),
        nc_u=len(ucones), nc_x=len(xcones),
    )


def _cone_rows(cone_ops, cone_mu_u, cone_shift_u, cone_mu_x, cone_shift_x,
               batch: int):
    """Per-instance ``(mu, shift)`` rows ``(nc_u + nc_x, B)`` over all cones
    in the table's order, or ``(None, None)`` when no override is given. A
    defaulted entry takes the cone's static value, so the rows are complete
    whenever one override is given."""
    has_pu = cone_mu_u is not None or cone_shift_u is not None
    has_px = cone_mu_x is not None or cone_shift_x is not None
    nc_u = cone_ops.nc_u if cone_ops is not None else 0
    nc_x = cone_ops.nc_x if cone_ops is not None else 0
    if (has_pu and not nc_u) or (has_px and not nc_x):
        raise ValueError("per-instance cone parameters without the "
                         "matching cones in cone_ops")
    if not (has_pu or has_px):
        return None, None
    dtype, device = cone_ops.mu.dtype, cone_ops.mu.device

    def rows(given, static, nc):
        if given is None:
            return static[:, None].expand(nc, batch)
        given = torch.as_tensor(given).to(device=device, dtype=dtype)
        if tuple(given.shape) != (nc, batch):
            raise ValueError(
                f"per-instance cone parameters must be ({nc}, {batch}), "
                f"got {tuple(given.shape)}")
        return given

    mu = torch.cat([rows(cone_mu_u, cone_ops.mu[:nc_u], nc_u),
                    rows(cone_mu_x, cone_ops.mu[nc_u:], nc_x)])
    shift = torch.cat([rows(cone_shift_u, cone_ops.shift[:nc_u], nc_u),
                       rows(cone_shift_x, cone_ops.shift[nc_u:], nc_x)])
    return mu.contiguous(), shift.contiguous()


def _apply_cones(W, group, dim: int, mu_rows, shift_rows, first: int):
    """Each cone of ``group`` in order on flat slacks ``W (B, K*dim)`` viewed
    per knot; ``mu_rows``/``shift_rows`` (``(nc, B)`` or None) give
    per-instance values, cone ``c`` of the group at row ``first + c``."""
    from ..solver.cones import _project

    if not group:
        return W
    Wk = W.reshape(W.shape[0], -1, dim).clone()
    for c, cone in enumerate(group):
        ball = list(cone.ball)
        if mu_rows is None:
            mu, shift = cone.mu, cone.shift
        else:
            mu = mu_rows[first + c][:, None]
            shift = shift_rows[first + c][:, None]
        v_new, s_new = _project(
            Wk[..., ball], Wk[..., cone.axis] + shift, mu, shift)
        Wk[..., cone.axis] = s_new
        Wk[..., ball] = v_new
    return Wk.reshape(W.shape[0], -1)


def _cone_fns(cone_ops, mu_rows, shift_rows, pp: PaddedProblem):
    """``(cone_u, cone_x)``: the slack-stage projections of the plain
    version, or None where there are no cones of that kind."""
    if cone_ops is None:
        return None, None
    nx, nu, _N = pp.dims
    cs = cone_ops.cones
    cone_u = cone_x = None
    if cs.input_cones:
        cone_u = lambda Z: _apply_cones(
            Z, cs.input_cones, nu, mu_rows, shift_rows, 0)
    if cs.state_cones:
        cone_x = lambda V: _apply_cones(
            V, cs.state_cones, nx, mu_rows, shift_rows, cone_ops.nc_u)
    return cone_u, cone_x


class FusedCarry(NamedTuple):
    """Warm-start carries persisting across MPC ticks, ``(B, .)`` unpadded.
    The reference keeps these in its global workspace between tiny_solve
    calls (examples/quadrotor_hovering.cpp:99-104 resets only the duals)."""

    D: torch.Tensor  # (B, Du)
    Y: torch.Tensor  # (B, Du)
    G: torch.Tensor  # (B, Dx)
    Z: torch.Tensor  # (B, Du)
    V: torch.Tensor  # (B, Dx)

    @staticmethod
    def zeros(batch: int, pp: PaddedProblem, dtype=torch.float32,
              device: Any = DEFAULT_DEVICE) -> "FusedCarry":
        fu = lambda: torch.zeros((batch, pp.Du), dtype=dtype, device=device)
        fx = lambda: torch.zeros((batch, pp.Dx), dtype=dtype, device=device)
        return FusedCarry(D=fu(), Y=fu(), G=fx(), Z=fu(), V=fx())

    def reset_duals(self) -> "FusedCarry":
        """Zero y/g between ticks (reference: tiny_wrapper.cpp:131-140)."""
        return self._replace(
            Y=torch.zeros_like(self.Y), G=torch.zeros_like(self.G))


class FusedResult(NamedTuple):
    """Solve outputs. ``U``/``X`` are the final pre-projection iterates (the
    reference applies pre-projection u --
    examples/quadrotor_hovering.cpp:104-110). ``stats[:, 0]`` iterations,
    ``stats[:, 1]`` solved flag, ``stats[:, 2:6]`` residuals [pri_state,
    dua_state, pri_input, dua_input]."""

    U: torch.Tensor
    X: torch.Tensor
    carry: FusedCarry
    stats: torch.Tensor  # (B, 6)


# ------------------------------------------------------------ plain version --

ALGOS = ("f32", "bf16x3")


def split_bf16(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-term bf16 decomposition ``w ~= hi + lo``: ``hi = bf16(w)`` (round
    to nearest even) carries the top 8 significand bits, ``lo = bf16(w -
    hi)`` the next 8 (the JAX package's ``_split_bf16``)."""
    hi = w.to(torch.bfloat16)
    lo = (w - hi.to(w.dtype)).to(torch.bfloat16)
    return hi, lo


def dot3(x: torch.Tensor, w: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """``x @ w`` in three bf16 passes with sums in ``x``'s type: ``x`` is
    split as :func:`split_bf16`, ``w`` comes split, and the result is
    ``xh wh + (xh wl + xl wh)`` (the ``lo lo`` term dropped), the grouping
    of the JAX package's ``_dot3``. Each bf16 product is exact in float32,
    so the passes run as float32 (float64 for float64 ``x``) products of
    the bf16 values."""
    wh, wl = w
    xh, xl = split_bf16(x)
    dot = lambda a, b: torch.matmul(a.to(x.dtype), b.to(x.dtype))
    return dot(xh, wh) + (dot(xh, wl) + dot(xl, wh))


def _dot(x: torch.Tensor, w) -> torch.Tensor:
    """An f32 operator (a tensor) or a split one (an ``(hi, lo)`` pair)."""
    return dot3(x, w) if isinstance(w, tuple) else torch.matmul(x, w)


def _operator_sets(pp: PaddedProblem, algo: str) -> tuple[tuple, tuple]:
    """``(split set, f32 set)`` of the in-loop operators ``(W_fd, W_gd, W_q,
    W_r)``; with ``algo="bf16x3"`` the split set holds ``(hi, lo)`` pairs,
    split once per solve, else it is the f32 set again."""
    f32 = (pp.W_fd, pp.W_gd, pp.W_q, pp.W_r)
    if algo == "bf16x3":
        return tuple(split_bf16(w) for w in f32), f32
    return f32, f32


def _iteration(D, Y, G, Z, V, W, pp: PaddedProblem, Xb, Ub, const_d, alpha,
               cone_u=None, cone_x=None):
    """One folded condensed ADMM iteration on ``(B, .)`` tensors -- the
    arithmetic of the kernel's forward/clip/dual/backward stages. Stage order
    is the reference's (src/tinympc/admm.cpp:117-150). ``W = (W_fd, W_gd,
    W_q, W_r)`` is the iteration's operator set: tensors (float32 products)
    or ``(hi, lo)`` pairs (:func:`dot3`). ``cone_u``/``cone_x`` project the
    clipped slacks onto the cones (composition after the box clip, as
    :func:`..solver.cones.cone_slack_update`)."""
    W_fd, W_gd, W_q, W_r = W
    X = Xb + _dot(D, W_fd)
    U = Ub + _dot(D, W_gd)
    if alpha != 1.0:
        Ur = alpha * U + (1.0 - alpha) * Z
        Xr = alpha * X + (1.0 - alpha) * V
    else:
        Ur, Xr = U, X
    S = Ur + Y
    Znew = torch.minimum(torch.maximum(S, pp.u_min), pp.u_max)
    if cone_u is not None:
        Znew = cone_u(Znew)
    Yn = S - Znew
    T = Xr + G
    Vnew = torch.minimum(torch.maximum(T, pp.x_min), pp.x_max)
    if cone_x is not None:
        Vnew = cone_x(Vnew)
    Gn = T - Vnew
    Dn = _dot(Vnew - Gn, W_q) + _dot(Znew - Yn, W_r) + const_d
    return Dn, Yn, Gn, Znew, Vnew, U, X


def split_iteration(it: int, *, algo: str = "f32", max_iter: int = 100,
                    check_termination: int = 0, warmup_iters: int = 0,
                    polish: int = 8) -> bool:
    """Whether iteration ``it`` (1-based) of a solve runs the split products
    (the JAX package's ``_fixed_core`` / ``_adaptive_core`` schedules).
    Fixed: the first ``max_iter - max(1, polish)`` iterations. Adaptive:
    every iteration but the checks past the warmup and the one at the cap
    (``polish`` is not read). Always False for ``algo="f32"``."""
    if algo != "bf16x3":
        return False
    if check_termination <= 0:
        return it <= fixed_split_iterations(max_iter, polish, algo)
    warmup = min(warmup_iters, max_iter - 1)
    return not (it > warmup and (it % check_termination == 0
                                 or it == max_iter))


def fixed_split_iterations(max_iter: int, polish: int, algo: str) -> int:
    """Iterations of a fixed ``algo="bf16x3"`` solve that run split (the
    first ``n3``; 0 for ``algo="f32"``), the kernels' ``n3``."""
    return max(0, max_iter - max(1, polish)) if algo == "bf16x3" else 0


def schedule_splits(algo: str, max_iter: int, check_termination: int = 0,
                    warmup_iters: int = 0, polish: int = 8) -> bool:
    """Whether a solve of this schedule runs any split iteration (some
    iteration :func:`split_iteration` names): a fixed one when ``polish <
    max_iter``; an adaptive one when it has a warmup or checks less often
    than every iteration."""
    if algo != "bf16x3":
        return False
    if check_termination <= 0:
        return fixed_split_iterations(max_iter, polish, algo) > 0
    return max_iter >= 2 and (min(warmup_iters, max_iter - 1) >= 1
                              or check_termination >= 2)


def _residuals(X, U, Z, V, Znew, Vnew, rho):
    """[pri_state, dua_state, pri_input, dua_input] per instance (reference
    admm.cpp:95-98: pre-projection iterates vs new slacks; old-vs-new slacks
    scaled by rho)."""
    amax = lambda a: a.abs().amax(dim=-1)
    return (amax(X - Vnew), amax(V - Vnew) * rho,
            amax(U - Znew), amax(Z - Znew) * rho)


def fused_solve_plain(
    x0: torch.Tensor, carry: FusedCarry, pp: PaddedProblem, *,
    max_iter: int = 100, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    warmup_iters: int = 0, xref_q=None, pterm_c=None, alpha: float = 1.0,
    const_d: torch.Tensor | None = None,
    cone_ops: FusedConeOps | None = None,
    cone_mu_u=None, cone_shift_u=None, cone_mu_x=None, cone_shift_x=None,
    algo: str = "f32", polish: int = 8,
) -> FusedResult:
    """Plain PyTorch version of the fused solve (fixed and adaptive): the
    kernel's arithmetic, stage by stage, on whole-batch tensors. Runs on any
    device and in float32 or float64. ``const_d`` (``(1, Du)``) gives the
    folded reference constant directly, as the rollout streams it. The cone
    arguments are those of :func:`fused_solve`.

    ``algo="bf16x3"`` runs the iterations that :func:`split_iteration`
    names with :func:`dot3` products (operators split once per solve, the
    iterate at every product) and the others, and the hoisted x0 products,
    in the input's type. float64 inputs take the same bf16 splits with
    float64 sums (the JAX fused tier has no float64)."""
    mu_rows, shift_rows = _cone_rows(
        cone_ops, cone_mu_u, cone_shift_u, cone_mu_x, cone_shift_x,
        x0.shape[0])
    if mu_rows is not None:
        mu_rows, shift_rows = mu_rows.to(x0.dtype), shift_rows.to(x0.dtype)
    cone_u, cone_x = _cone_fns(cone_ops, mu_rows, shift_rows, pp)
    with torch.no_grad():
        if const_d is None:
            const_d = fold_const_d(pp, xref_q, pterm_c)
        Xb = torch.matmul(x0, pp.W_fx)
        Ub = torch.matmul(x0, pp.W_gx)
        D, Y, G, Z, V = carry
        B = x0.shape[0]
        W3, Wf = _operator_sets(pp, algo)
        sched = dict(algo=algo, max_iter=max_iter,
                     check_termination=check_termination,
                     warmup_iters=warmup_iters, polish=polish)
        step = lambda it, D, Y, G, Z, V: _iteration(
            D, Y, G, Z, V, W3 if split_iteration(it, **sched) else Wf, pp,
            Xb, Ub, const_d, alpha, cone_u, cone_x)
        stats = torch.zeros((B, 6), dtype=x0.dtype, device=x0.device)

        if check_termination <= 0:
            for it in range(1, max_iter):
                D, Y, G, Z, V, _U, _X = step(it, D, Y, G, Z, V)
            Dn, Yn, Gn, Znew, Vnew, U, X = step(max_iter, D, Y, G, Z, V)
            # Residuals of the final iteration against the pre-save slacks.
            stats[:, 0] = max_iter
            for k, r in enumerate(
                    _residuals(X, U, Z, V, Znew, Vnew, pp.rho)):
                stats[:, 2 + k] = r
            return FusedResult(
                U=U, X=X, carry=FusedCarry(Dn, Yn, Gn, Znew, Vnew),
                stats=stats)

        # Adaptive: a converged instance stops. What it returns is D, Z, V
        # from before its freezing check iteration (backward pass and slack
        # save skipped), Y, G after it, U, X of it.
        warmup = min(warmup_iters, max_iter - 1)
        done = torch.zeros((B,), dtype=torch.bool, device=x0.device)
        U = torch.zeros_like(D)
        X = torch.zeros_like(G)
        col = lambda m: m[:, None]
        for it in range(1, max_iter + 1):
            Dn, Yn, Gn, Znew, Vnew, Un, Xn = step(it, D, Y, G, Z, V)
            live = ~done
            newly = torch.zeros_like(done)
            if it > warmup and it % check_termination == 0:
                ps, ds, pu, du = _residuals(Xn, Un, Z, V, Znew, Vnew, pp.rho)
                for k, r in enumerate((ps, ds, pu, du)):
                    stats[:, 2 + k] = torch.where(live, r, stats[:, 2 + k])
                newly = live & (ps < abs_pri_tol) & (pu < abs_pri_tol) \
                    & (ds < abs_dua_tol) & (du < abs_dua_tol)
                stats[:, 0] = torch.where(
                    newly, torch.full_like(stats[:, 0], it), stats[:, 0])
            cont = live & ~newly
            U = torch.where(col(live), Un, U)
            X = torch.where(col(live), Xn, X)
            Y = torch.where(col(live), Yn, Y)
            G = torch.where(col(live), Gn, G)
            D = torch.where(col(cont), Dn, D)
            Z = torch.where(col(cont), Znew, Z)
            V = torch.where(col(cont), Vnew, V)
            done = done | newly
            if bool(done.all()):
                break
        stats[:, 1] = done.to(stats.dtype)
        stats[:, 0] = torch.where(
            done, stats[:, 0], torch.full_like(stats[:, 0], max_iter))
        return FusedResult(
            U=U, X=X, carry=FusedCarry(D, Y, G, Z, V), stats=stats)


# ------------------------------------------------------------------ kernel --

def split_words(nx: int, nu: int, horizon: int) -> int:
    """32-bit words of the split-bf16 operator fragments (``split_words``
    in ``csrc/admm_iteration.cuh``): Wf^T and Wb^T in tiles of 16 rows by
    16 depth, 256 words (hi and lo halves) a tile."""
    Dx, Du = horizon * nx, (horizon - 1) * nu
    t = lambda n: -(-n // 16)
    Dz = Dx + Du
    return 256 * (t(Dz) * t(Du) + t(Du) * t(Dz))


def kernel_smem_bytes(nx: int, nu: int, horizon: int, tile: int,
                      ncp: int = 0, placement: str = "shared",
                      split: bool = False) -> int:
    """Dynamic shared memory one block needs: mirrors ``make_layout`` in
    ``csrc/admm_iteration.cuh`` (the C entry refuses a launch when the two
    disagree). ``ncp`` is the number of cones with per-instance mu/shift
    rows (0 for static cone parameters and for box-only solves): the coned
    kernels need nothing else beyond the box layout. ``placement="device"``
    leaves the operators Wf, Wb, Wx out (the kernels read them from device
    memory). ``split`` (the ``algo="bf16x3"`` kernels) adds a flag per
    slot and, with the operators staged, holds the backward operator's
    split fragments (:func:`split_words`, its Wb^T part) in place of Wb and
    Wx, which those kernels read from device memory (the forward
    operator's fragments stay there too): they run the float32 kernels'
    slots."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    r4 = lambda n: (n + 3) & ~3
    Dx, Du = horizon * nx, (horizon - 1) * nu
    DuP, DzP = r4(Du), r4(Dx + Du)
    operators = DuP * DzP + DzP * DuP + nx * DzP    # Wf, Wb, Wx
    words = (
        (operators if placement == "shared" else 0)
        + 2 * DzP                                  # lo, hi
        + r4(nx * nx) + r4(nx * nu)
        + 2 * tile * DuP + 5 * tile * DzP          # D, cd; S, YG, ZV x2, Xb
        + r4(tile * nx) + r4(tile * nu) + r4(tile * 6) + r4(tile * 4)
        + 9 * tile + 4                             # per-slot ints, nref
        + 2 * r4(ncp * tile)
    )
    if split:
        words += tile
        if placement == "shared":
            t16 = lambda n: -(-n // 16)
            words += 256 * t16(Du) * t16(Dx + Du) - DzP * DuP - nx * DzP
    return 4 * words


def fixed_smem_bytes(nx: int, nu: int, horizon: int, tile: int,
                     placement: str = "shared") -> int:
    """Dynamic shared memory of K1's own body (the ``"waves"`` path of
    :func:`fixed_path`): mirrors ``make_wave_layout`` in
    ``csrc/fixed_waves.cuh`` (the C entry refuses a launch when the two
    disagree). The operators Wf and Wb (unless ``placement="device"``),
    the bounds, one const_d row, and per slot D, S, x0 and the residual
    maxima: a slot's dual, slack and x0 terms live in registers."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}")
    r4 = lambda n: (n + 3) & ~3
    Dx, Du = horizon * nx, (horizon - 1) * nu
    DuP, DzP = r4(Du), r4(Dx + Du)
    words = (
        (2 * DuP * DzP if placement == "shared" else 0)   # Wf, Wb
        + 2 * DzP + DuP                                   # lo, hi; const_d
        + tile * (DuP + DzP) + r4(tile * nx) + r4(tile * 4)
        + 4                                               # the wave
    )
    return 4 * words


# K1 (the fixed box-only float32 solve) runs on its own body, the slots of a
# block in lockstep with each thread's iterates in its registers
# (``csrc/fixed_waves.cuh``), wherever :func:`fixed_path` says "waves";
# False runs every K1 launch on the shared slot body (``run_block``). At one
# launch geometry both give the same bits.
FIXED_WAVES = True


def fixed_path(dims: tuple, tile: int, threads: int, ri: int,
               algo: str = "f32", alpha: float = 1.0) -> str:
    """The body a fixed box-only solve at ``tile`` slots, ``threads`` threads
    and register tile ``ri`` runs: ``"waves"`` (K1's own body: float32,
    register tiles of 8 slots, and every forward item of the block, a
    register tile of 8 slots by 4 columns of z, held by a thread of its
    own; ``wave_fits`` in ``csrc/fixed_waves.cuh``) where
    :data:`FIXED_WAVES` holds, else ``"slots"`` (the shared body, which
    the other kernels run). The geometry is the shared body's own
    (:func:`geometry`), so both paths split the backward product's depth
    alike and give the same bits. An over-relaxed solve (``alpha`` other
    than 1) takes the shared body, and K1's own body has no relaxation (its
    C entry refuses such a launch): nvcc fused ``alpha x + (1 - alpha) z``
    into FMAs differently in the two bodies, which moved bits on an
    H100."""
    nx, nu, N = dims
    DzP = (N * nx + (N - 1) * nu + 3) & ~3
    if (algo != "f32" or not FIXED_WAVES or ri != REGISTER_TILE
            or alpha != 1.0 or (tile // ri) * (DzP // 4) > threads):
        return "slots"
    return "waves"


def backward_split(dims: tuple, tile: int, threads: int, ri: int) -> int:
    """The backward product's depth split of a launch: the lanes over which
    a register tile's depth is summed (``ksplit_of`` in
    ``csrc/fused_entry.cuh``), as many (at most 8) as give every thread a
    tile. It sets the order of that product's sums, so two launches give
    the same bits only where it is the same."""
    nx, nu, N = dims
    r4 = lambda n: (n + 3) & ~3
    DuP, DzP = r4((N - 1) * nu), r4(N * nx + (N - 1) * nu)
    btiles = (DuP // 4) * (tile // ri)
    H = 1
    while H < 8 and btiles * H * 2 <= threads and H * 2 <= DzP // 4:
        H *= 2
    return H


def _tpu_fits(nx: int, nu: int, horizon: int) -> bool:
    """Whether the JAX package's fused tier takes this horizon: its sizing
    (``accelerated_tinympc_tpu/ops/fused_admm.py`` ``fused_solve``) keeps
    the packed operators and 8 rows of its blocks inside a 12 MB VMEM budget.
    A copy of that arithmetic, used only to name the boundary in an error."""
    lanes, stats, max_pack = 128, 128, 8
    pad = lambda n: -(-n // lanes) * lanes
    Dx, Du = horizon * nx, (horizon - 1) * nu
    g = 1 if 2 * Du > lanes else max(1, min(max_pack, lanes // Du))
    Dug, gDxp, nxg = pad(g * Du), g * pad(Dx), pad(g * nx)
    w = 4 * (nxg * gDxp + Dug * gDxp + nxg * Dug + 2 * Dug * Dug
             + gDxp * Dug)
    per_row = 4 * (2 * (nxg + 3 * Dug + 2 * gDxp)
                   + 2 * (4 * Dug + 3 * gDxp + g * stats)
                   + 10 * gDxp + 6 * Dug)
    return w + 8 * per_row <= 12 * 1024 * 1024


def tpu_horizon_limit(nx: int, nu: int) -> int:
    """The longest horizon the JAX package's fused tier takes for these
    widths (N=129 for the quadrotor, 213 for the lander)."""
    N = 2
    while _tpu_fits(nx, nu, N + 1):
        N += 1
    return N


def choose_placement(dims: tuple, limit: int = SMEM_LIMIT_BYTES,
                     ncp: int = 0, split: bool = False) -> str:
    """Where the kernels keep the condensed operators: ``"shared"`` wherever
    they fit beside one register tile of 8 slots (every shape that ran
    before the device placement keeps its kernel), else ``"device"`` (read
    from device memory, resident in L2) while one register tile of per-slot
    state fits, of 8 slots or else of 4. Raises past that, with the bytes
    needed. ``split``: the ``algo="bf16x3"`` kernels' layout (a flag per
    slot beside the float32 one)."""
    nx, nu, N = dims
    if kernel_smem_bytes(nx, nu, N, REGISTER_TILE, ncp, "shared",
                         split) <= limit:
        return "shared"
    need = kernel_smem_bytes(nx, nu, N, REGISTER_TILES[-1], ncp, "device",
                             split)
    if need <= limit:
        return "device"
    raise ValueError(
        f"the fused tier's per-slot state for nx={nx}, nu={nu}, horizon={N} "
        f"needs {need} bytes of shared memory per block with the condensed "
        f"operators in device memory and {REGISTER_TILES[-1]} slots (limit "
        f"{limit}); the JAX package's fused tier takes these widths up to "
        f"N={tpu_horizon_limit(nx, nu)} (a TPU's 12 MB VMEM budget); longer "
        "horizons belong to the stream tier")


def choose_register_tile(dims: tuple, limit: int = SMEM_LIMIT_BYTES,
                         ncp: int = 0, placement: str | None = None,
                         split: bool = False) -> int:
    """Slots per register tile at ``placement`` (default
    :func:`choose_placement`): 8 wherever one such tile fits (every shape
    that ran before keeps its kernel), else 4, which only the device
    placement takes. Raises if neither fits."""
    nx, nu, N = dims
    if placement is None:
        placement = choose_placement(dims, limit, ncp, split)
    for ri in REGISTER_TILES:
        if ri != REGISTER_TILE and placement != "device":
            break
        if kernel_smem_bytes(nx, nu, N, ri, ncp, placement, split) <= limit:
            return ri
    need = kernel_smem_bytes(nx, nu, N, ri, ncp, placement, split)
    raise ValueError(
        f"one register tile of {ri} slots at nx={nx}, nu={nu}, horizon={N} "
        f"needs {need} bytes of shared memory with the operators in "
        f"{placement} memory (limit {limit})")


def choose_tile(dims: tuple, batch: int, n_sm: int = 132,
                limit: int = SMEM_LIMIT_BYTES, ncp: int = 0,
                placement: str | None = None,
                register_tile: int | None = None,
                split: bool = False) -> int:
    """Slots per block: the largest multiple of the register tile that fits
    shared memory, not more than spreads the batch over all SMs, at
    ``placement`` (default: :func:`choose_placement`, which raises if even
    one register tile does not fit) and ``register_tile`` slots per register
    tile (default: :func:`choose_register_tile`); ``split`` as there."""
    nx, nu, N = dims
    if placement is None:
        placement = choose_placement(dims, limit, ncp, split)
    ri = register_tile or choose_register_tile(dims, limit, ncp, placement,
                                               split)
    if ri not in REGISTER_TILES or (ri != REGISTER_TILE
                                    and placement != "device"):
        raise ValueError(f"register tiles of {ri} slots: take 8, or 4 with "
                         "the operators in device memory")
    need = kernel_smem_bytes(nx, nu, N, ri, ncp, placement, split)
    if need > limit:
        raise ValueError(
            f"one register tile of {ri} slots at nx={nx}, nu={nu}, "
            f"horizon={N} needs {need} bytes of shared memory with the "
            f"operators in {placement} memory (limit {limit})")
    fit = ri
    while (fit + ri <= MAX_TILE and
           kernel_smem_bytes(nx, nu, N, fit + ri, ncp, placement,
                             split) <= limit):
        fit += ri
    per_sm = -(-batch // n_sm)
    want = -(-per_sm // ri) * ri
    return max(ri, min(fit, want))


_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
# The C entries' parameters in order (csrc/fused_entry.cuh); every pointer
# and the stream are c_void_p.
_SOLVE_ARGTYPES = ([_P] * 22 + [_I] * 2 + [_P] * 3 + [_I, _P] + [_I] * 7
                   + [_F] * 4 + [_I] * 6 + [_P, _I, _P])
_ROLLOUT_ARGTYPES = ([_P] * 25 + [_I] * 2 + [_P, _I, _P] + [_I] * 9
                     + [_F] * 4 + [_I] * 5 + [_P, _I, _P])


def _library(algo: str = "f32") -> ctypes.CDLL:
    """Load (building at first use) the kernels of ``algo`` (the float32
    ones from ``csrc/fused_admm.cu``, the split-bf16 ones from
    ``csrc/fused_admm_bf16x3.cu``; both export the same C entries) and
    declare their C signatures; every pointer and the stream are
    ``c_void_p``."""
    from ._build import load_library

    lib = load_library("fused_admm_bf16x3" if algo == "bf16x3"
                       else "fused_admm")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_fused_smem_bytes.argtypes = [_I] * 6
        lib.atm_fused_smem_bytes.restype = _I
        lib.atm_fused_split_words.argtypes = [_I] * 3
        lib.atm_fused_split_words.restype = _I
        lib.atm_fused_fixed_smem_bytes.argtypes = [_I] * 5
        lib.atm_fused_fixed_smem_bytes.restype = _I
        lib.atm_fused_solve.argtypes = _SOLVE_ARGTYPES
        lib.atm_fused_solve.restype = _I
        lib.atm_fused_rollout.argtypes = _ROLLOUT_ARGTYPES
        lib.atm_fused_rollout.restype = _I
        lib._atm_declared = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(
            f"{name} is {t.dtype}: the CUDA kernels are float32 "
            "(use the plain tiers for float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def _checked_operands(W_f, W_b, W_x, lo, hi, dims, device) -> tuple:
    """``W_f, W_b, W_x`` (padded to float4 rows, :class:`PaddedProblem`),
    ``lo``, ``hi``, checked against ``dims`` and ``device``: the kernels
    read them through raw pointers at these shapes."""
    nx, nu, N = dims
    r4 = lambda n: (n + 3) & ~3
    Du, Dz = (N - 1) * nu, N * nx + (N - 1) * nu
    DuP, DzP = r4(Du), r4(Dz)
    return (
        _check("W_f", W_f, (DuP, DzP), device),
        _check("W_b", W_b, (DzP, DuP), device),
        _check("W_x", W_x, (nx, DzP), device),
        _check("lo", lo, (Dz,), device),
        _check("hi", hi, (Dz,), device),
    )


def _geometry(dims: tuple, B: int, device, batch_tile, threads,
              ncp: int = 0, placement: str | None = None,
              register_tile: int | None = None, split: bool = False):
    """:func:`geometry` on ``device``'s SMs and shared memory."""
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    return geometry(dims, B, props.multi_processor_count, limit, batch_tile,
                    threads, ncp, placement, register_tile, split)


def geometry(dims: tuple, B: int, n_sm: int = 132,
             limit: int = SMEM_LIMIT_BYTES, batch_tile=None, threads=None,
             ncp: int = 0, placement: str | None = None,
             register_tile: int | None = None, split: bool = False):
    """``(tile, threads, smem bytes, placement, register tile)`` of one
    launch on a card of ``n_sm`` SMs and ``limit`` bytes of shared memory a
    block (an H100's by default); the placement is
    :func:`choose_placement`'s and the register tile
    :func:`choose_register_tile`'s unless given. ``split``: the
    ``algo="bf16x3"`` kernels. The bytes are the shared body's layout
    (:func:`kernel_smem_bytes`; K1's own body takes
    :func:`fixed_smem_bytes` at the same tile)."""
    nx, nu, N = dims
    if placement is None:
        placement = choose_placement(dims, limit, ncp, split)
    ri = register_tile or choose_register_tile(dims, limit, ncp, placement,
                                               split)
    if batch_tile is None:
        tile = choose_tile(dims, B, n_sm, limit, ncp, placement, ri, split)
    else:
        tile = max(ri, -(-int(batch_tile) // ri) * ri)
        tile = min(tile, choose_tile(dims, 10 ** 9, 1, limit, ncp,
                                     placement, ri, split))
    if threads is None:
        threads = (MAX_THREADS if ri != REGISTER_TILE
                   else min(MAX_THREADS, THREADS_PER_INSTANCE * tile))
    threads = max(int(threads), -(-tile // 32) * 32)
    return (tile, threads,
            kernel_smem_bytes(nx, nu, N, tile, ncp, placement, split),
            placement, ri)


def _split_scratch(lib, dims: tuple, splits: bool, device):
    """The split-bf16 kernels' scratch for the operator fragments, split
    once per launch; ``None`` where the launch splits no iteration (the
    float32 kernels, and a split-bf16 schedule without split iterations,
    whose layout then holds no fragments)."""
    if not splits:
        return None
    words = lib.atm_fused_split_words(*dims)
    if words != split_words(*dims):
        raise RuntimeError("split_words of the wrapper and the kernel "
                           f"disagree ({split_words(*dims)} vs {words})")
    return torch.empty(words, dtype=torch.int32, device=device)


def work_counter(device) -> torch.Tensor:
    """The kernels' work counter: one int, zero at launch (the kernels
    allocate nothing)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _cone_table(cone_ops: FusedConeOps | None, device):
    """The C entries' cone arguments ``(idx, par, nc_u, nc_x)``: pointers to
    the device table of :func:`pad_cones` (``None, None, 0, 0`` without
    cones), plus the tensors that must outlive the call."""
    if cone_ops is None or not (cone_ops.nc_u or cone_ops.nc_x):
        return None, None, 0, 0, ()
    table = cone_ops.table.to(device=device, dtype=torch.int32).contiguous()
    params = cone_ops.params.to(device=device,
                                dtype=torch.float32).contiguous()
    return (table.data_ptr(), params.data_ptr(), cone_ops.nc_u,
            cone_ops.nc_x, (table, params))


# Coned float32 launches fold the cone projections and the dual ascent into
# the forward stage (``cone_forward_stage`` in csrc/admm_iteration.cuh)
# wherever :func:`cone_items` lays the columns out; False runs the three
# coned passes (``cone_stage``, ``finish_stage``) on every launch, as the
# split-bf16 kernels always do. Both give the same bits.
FUSED_CONES = True


# One warp pass of the fused cone pass (``RUN_WORDS`` in
# csrc/admm_iteration.cuh): 32 items, the counts of its coned state and
# input knots, then those knots (at most 4 start in each of 32 groups).
RUN_WORDS = 32 + 2 + 128


@functools.lru_cache(maxsize=64)
def cone_items(dims: tuple, tile: int, ri: int, has_u: bool, has_x: bool):
    """Runs of the fused cone pass (``cone_forward_stage``): every slot
    group's columns of z in runs of 32 items, one run a warp pass, a run
    cut only between knots of a kind that has cones (state knots if
    ``has_x``, input knots if ``has_u``), so that each such knot lies in one
    warp. An item is ``g << 20 | cg << 8 | own``: register tile ``g`` (slots
    ``g * ri`` on), column group ``cg`` (columns ``4 cg`` on) and the bits of
    the four columns it owns (a group cut inside sits at the end of one run
    and the start of the next, each owning its side); -1 pads a run. Each
    run takes the furthest cut whose groups fit its lanes. After its 32
    items a run holds the counts of its coned state and input knots, then
    those knots, state knots first, each ``g << 16 | first column``.
    Returns an int32 array ``(runs, RUN_WORDS)``, or None where one knot
    spans more column groups than a warp has lanes (the three coned passes
    take that)."""
    nx, nu, N = dims
    Dx, Du = N * nx, (N - 1) * nu
    W = (Dx + Du + 3) & ~3
    if W // 4 > 0xfff:
        return None
    knot = np.full(W, -1)
    if has_x:
        knot[:Dx] = np.arange(Dx) // nx
    if has_u:
        knot[Dx:Dx + Du] = N + np.arange(Du) // nu
    cut = np.ones(W + 1, bool)    # a run may end before column b
    cut[1:W] = (knot[:-1] < 0) | (knot[:-1] != knot[1:])
    start = (knot >= 0) & np.r_[True, knot[1:] != knot[:-1]]
    runs = []
    run, knots = [], []

    def close():
        xs = sorted(k for k in knots if k & 0xffff < Dx)
        us = sorted(k for k in knots if k & 0xffff >= Dx)
        row = run + [-1] * (32 - len(run)) + [len(xs), len(us)] + xs + us
        runs.append(row + [-1] * (RUN_WORDS - len(row)))
        run.clear()
        knots.clear()

    for g in range(tile // ri):
        b0 = 0
        while b0 < W:
            room = 32 - len(run)
            b1 = best = b0
            while b1 < W and -(-(b1 + 1) // 4) - b0 // 4 <= room:
                b1 += 1
                if cut[b1]:
                    best = b1
            if best == b0:        # the next knot does not fit this run
                if not run:
                    return None
                close()
                continue
            for cg in range(b0 // 4, -(-best // 4)):
                cols = range(max(b0, 4 * cg), min(best, 4 * cg + 4))
                run.append(g << 20 | cg << 8 | sum(1 << (c - 4 * cg)
                                                     for c in cols))
                knots.extend(g << 16 | c for c in cols if start[c])
            b0 = best
            if len(run) == 32:
                close()
    if run:
        close()
    return np.asarray(runs, np.int32)


def cone_path(dims: tuple, tile: int, ri: int, cone_ops,
              algo: str = "f32") -> str | None:
    """The coned slack stage a launch at ``tile`` slots and register tile
    ``ri`` runs: ``"fused"`` (one pass with the forward product: the float32
    kernels where :func:`cone_items` lays the columns out and
    :data:`FUSED_CONES` holds), ``"three-pass"`` (the split-bf16 kernels,
    and every other coned launch), None without cones."""
    if cone_ops is None or not (cone_ops.nc_u or cone_ops.nc_x):
        return None
    if algo != "f32" or not FUSED_CONES:
        return "three-pass"
    items = cone_items(tuple(dims), tile, ri, cone_ops.nc_u > 0,
                       cone_ops.nc_x > 0)
    return "three-pass" if items is None else "fused"


_ITEMS_ON_DEVICE: dict = {}


def _cone_items_arg(cone_ops, dims: tuple, tile: int, ri: int, algo: str,
                    device):
    """The C entries' ``(cone_items, cone_chunks)`` (``None, 0`` unless the
    launch takes the fused cone pass, :func:`cone_path`), plus the tensor
    that must outlive the call (one copy per device and layout)."""
    if cone_path(dims, tile, ri, cone_ops, algo) != "fused":
        return None, 0, None
    key = (tuple(dims), tile, ri, cone_ops.nc_u > 0, cone_ops.nc_x > 0,
           str(device))
    items = _ITEMS_ON_DEVICE.get(key)
    if items is None:
        items = torch.as_tensor(cone_items(*key[:5]), device=device)
        _ITEMS_ON_DEVICE[key] = items
    return items.data_ptr(), items.shape[0], items


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(
            f"{what}: launch geometry refused (shared-memory layout of the "
            "wrapper and the kernel disagree, or tile/threads out of range)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _check_algo(algo: str) -> None:
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; use 'f32' or 'bf16x3'")


def fused_solve(
    x0: torch.Tensor,
    carry: FusedCarry,
    pp: PaddedProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    warmup_iters: int = 0,
    xref_q: torch.Tensor | None = None,
    pterm_c: torch.Tensor | None = None,
    algo: str = "f32",
    polish: int = 8,
    cone_ops: FusedConeOps | None = None,
    cone_mu_u=None,
    cone_shift_u=None,
    cone_mu_x=None,
    cone_shift_x=None,
    alpha: float = 1.0,
    threads: int | None = None,
    placement: str | None = None,
    register_tile: int | None = None,
) -> FusedResult:
    """Run the fused whole-solve over a batch.

    ``cone_ops`` (from :func:`pad_cones`) appends exact second-order-cone
    projections to the slack stage; composition after the box clip matches
    the scan tier's ``cone_slack_update`` exactly.
    ``cone_mu_u``/``cone_shift_u`` (``(n_input_cones, B)``; likewise ``*_x``
    for state cones) override the cones' scalar parameters *per instance* --
    constraint-parameter sweeps (e.g. per-lander tilt limits) over one shared
    plant; per-instance *geometry* (ball/axis) needs the instance-ops tier.
    Where they equal the static scalars the arithmetic is the same, so the
    result is too. Requires ``cone_ops``.

    ``x0`` is ``(B, nx)``; carries are :class:`FusedCarry`. Any batch size is
    taken (the kernel masks the ragged edge of the last tile).
    ``check_termination == 0`` selects the fixed-iteration kernel, otherwise
    the adaptive kernel with checks every ``check_termination`` iterations.
    ``xref_q``/``pterm_c`` override the baked reference vectors (tracking
    mode -- build them with :func:`ref_vectors`). ``warmup_iters`` (adaptive
    mode only) runs that many iterations without convergence checks first.
    ``batch_tile`` (slots per block) and ``threads`` override the
    kernel's launch geometry, ``placement`` (``"shared"``/``"device"``)
    where it keeps the operators (default :func:`choose_placement`) and
    ``register_tile`` the slots per register tile (8, or 4 with the device
    placement; default :func:`choose_register_tile`); every choice gives the
    same bits where it fits, at one launch geometry (the backward product's
    depth split follows slots and threads).

    ``algo="bf16x3"`` is the JAX package's split-operand mode: the
    iterations that :func:`split_iteration` names run their two products
    as three bf16 passes with float32 sums (:func:`dot3`; on the card
    ``mma.sync`` bf16 tensor-core products, ``csrc/fused_admm_bf16x3.cu``),
    the others in float32: fixed solves the last ``polish`` iterations,
    adaptive solves every check past the warmup and the iteration at the
    cap, so the residuals that decide a freeze are float32 ones. The hoisted
    x0 products stay float32. An unknown ``algo`` raises ``ValueError``.

    Tensors on the CPU go through :func:`fused_solve_plain`; tensors on a
    CUDA device launch the kernel (float32 only) or raise.
    """
    _check_algo(algo)
    if max_iter < 1:
        raise ValueError("the fused tier runs at least one iteration; "
                         "use the scan tier for max_iter=0")
    if not x0.is_cuda:
        return check_outputs(fused_solve_plain(
            x0, carry, pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            warmup_iters=warmup_iters, xref_q=xref_q, pterm_c=pterm_c,
            alpha=alpha, cone_ops=cone_ops,
            cone_mu_u=cone_mu_u, cone_shift_u=cone_shift_u,
            cone_mu_x=cone_mu_x, cone_shift_x=cone_shift_x,
            algo=algo, polish=polish,
        ), "fused_solve")

    B = x0.shape[0]
    mu_rows, shift_rows = _cone_rows(
        cone_ops, cone_mu_u, cone_shift_u, cone_mu_x, cone_shift_x, B)
    with torch.no_grad():
        const_d = fold_const_d(pp, xref_q, pterm_c)
    return check_outputs(_launch_solve(
        x0, carry, pp.W_f, pp.W_b, pp.W_x, const_d, pp.lo, pp.hi, pp.dims,
        pp.rho_f,
        max_iter=max_iter, check_termination=check_termination,
        warmup_iters=warmup_iters, abs_pri_tol=abs_pri_tol,
        abs_dua_tol=abs_dua_tol, alpha=alpha, batch_tile=batch_tile,
        threads=threads, placement=placement, register_tile=register_tile,
        cone_ops=cone_ops, mu_rows=mu_rows, shift_rows=shift_rows,
        algo=algo, polish=polish,
    ), "fused_solve")


def _launch_solve(
    x0, carry, W_f, W_b, W_x, const_d, lo, hi, dims, rho_f, *, max_iter,
    check_termination, warmup_iters, abs_pri_tol, abs_dua_tol, alpha,
    batch_tile, threads, placement, register_tile, cone_ops=None,
    mu_rows=None, shift_rows=None, algo="f32", polish=8,
) -> FusedResult:
    """One launch of K1 (``check_termination == 0``) or K2 on CUDA tensors,
    float32 or split-bf16 (``algo``): checks the operands, sizes the launch
    (:func:`_geometry`; K1's box-only float32 launches on its own body
    where :func:`fixed_path` says so), zeroes the work counter, counts the
    launch.
    :func:`fused_solve` and the ``atm_torch::fused_solve`` op both launch
    through here."""
    nx, nu, N = dims
    Dx, Du = N * nx, (N - 1) * nu
    B = x0.shape[0]
    dev = x0.device
    cone_idx, cone_par, nc_u, nc_x, _alive = _cone_table(cone_ops, dev)
    coned = cone_idx is not None
    ncp = 0
    if mu_rows is not None:
        ncp = cone_ops.nc_u + cone_ops.nc_x
        mu_rows = _check("cone mu rows", mu_rows, (ncp, B), dev)
        shift_rows = _check("cone shift rows", shift_rows, (ncp, B), dev)
    x0 = _check("x0", x0, (B, nx), dev)
    D0 = _check("carry.D", carry.D, (B, Du), dev)
    Y0 = _check("carry.Y", carry.Y, (B, Du), dev)
    G0 = _check("carry.G", carry.G, (B, Dx), dev)
    Z0 = _check("carry.Z", carry.Z, (B, Du), dev)
    V0 = _check("carry.V", carry.V, (B, Dx), dev)
    const_d = _check("const_d", const_d, (1, Du), dev)
    W_f, W_b, W_x, lo, hi = _checked_operands(W_f, W_b, W_x, lo, hi, dims,
                                              dev)
    splits = schedule_splits(algo, max_iter, check_termination,
                             warmup_iters, polish)
    tile, threads, smem, placement, ri = _geometry(
        dims, B, dev, batch_tile, threads, ncp, placement, register_tile,
        splits)
    items, chunks, _items = _cone_items_arg(cone_ops, dims, tile, ri, algo,
                                            dev)
    adaptive = check_termination > 0
    waves = (not adaptive and not coned
             and fixed_path(dims, tile, threads, ri, algo, alpha) == "waves")
    if waves:
        smem = fixed_smem_bytes(nx, nu, N, tile, placement)

    new = lambda w: torch.empty((B, w), dtype=torch.float32, device=dev)
    U, X, D, Y, G, Z, V = (new(Du), new(Dx), new(Du), new(Du), new(Dx),
                           new(Du), new(Dx))
    stats = new(6)
    counter = work_counter(dev)
    lib = _library(algo)
    w3 = _split_scratch(lib, dims, splits, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.atm_fused_solve(
            x0.data_ptr(), D0.data_ptr(), Y0.data_ptr(), G0.data_ptr(),
            Z0.data_ptr(), V0.data_ptr(),
            W_f.data_ptr(), W_b.data_ptr(), W_x.data_ptr(),
            const_d.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            U.data_ptr(), X.data_ptr(), D.data_ptr(), Y.data_ptr(),
            G.data_ptr(), Z.data_ptr(), V.data_ptr(), stats.data_ptr(),
            cone_idx, cone_par, nc_u, nc_x,
            mu_rows.data_ptr() if ncp else None,
            shift_rows.data_ptr() if ncp else None,
            items, chunks, counter.data_ptr(),
            B, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            min(int(warmup_iters), int(max_iter) - 1) if adaptive else 0,
            float(rho_f), float(alpha),
            float(abs_pri_tol), float(abs_dua_tol),
            tile, threads, smem, int(placement == "device"), ri, int(waves),
            None if w3 is None else w3.data_ptr(),
            0 if adaptive else fixed_split_iterations(max_iter, polish, algo),
            stream,
        )
    _raise_on(err, "fused_solve")
    LAUNCH_COUNTS[kernel_name(
        "fused_solve_adaptive" if adaptive else "fused_solve_fixed", coned,
        algo)] += 1
    return FusedResult(
        U=U, X=X, carry=FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), stats=stats)


# ------------------------------------------------- the torch.library op --
# K1/K2 as an operator of its own, ``torch.ops.atm_torch.fused_solve``, so
# that ``torch.export`` can trace a fused solve into an artifact (a ctypes
# call is opaque to it; :mod:`..api.export`). It takes the kernel's
# operands and scalars and returns fresh tensors ``(U, X, D, Y, G, Z, V,
# stats)``. On CUDA tensors it is the launch of :func:`_launch_solve`; on the
# CPU it is :func:`fused_solve_plain`. Cones are not among its arguments.
# ``batch_tile`` -1 leaves the slots per block to the launch.

_Tensors8 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _plain_operands(W_f, W_b, W_x, lo, hi, dims, rho_f) -> PaddedProblem:
    """The blocks of the kernel operands that :func:`fused_solve_plain`
    reads, cut back out of ``W_f = [W_fd | W_gd]``, ``W_b = [W_q; W_r]``,
    ``W_x = [W_fx | W_gx]``, ``lo``/``hi`` (the same values, so the same
    products)."""
    nx, nu, N = dims
    Dx, Du = N * nx, (N - 1) * nu
    Dz = Dx + Du
    c = lambda a: a.contiguous()
    return PaddedProblem(
        W_fx=c(W_x[:, :Dx]), W_fd=c(W_f[:Du, :Dx]), W_gx=c(W_x[:, Dx:Dz]),
        W_gd=c(W_f[:Du, Dx:Dz]), W_q=c(W_b[:Dx, :Du]), W_r=c(W_b[Dx:Dz, :Du]),
        W_eq_u=None, W_ep_u=None, xref_q=None, pterm_c=None,
        u_min=c(lo[None, Dx:]), u_max=c(hi[None, Dx:]),
        x_min=c(lo[None, :Dx]), x_max=c(hi[None, :Dx]),
        rho=torch.tensor(rho_f, dtype=lo.dtype, device=lo.device),
        W_x=W_x, W_f=W_f, W_b=W_b, lo=lo, hi=hi, dims=tuple(dims),
        rho_f=rho_f)


def _op_result(res: FusedResult) -> _Tensors8:
    c = res.carry
    return (res.U, res.X, c.D, c.Y, c.G, c.Z, c.V, res.stats)


@torch.library.custom_op("atm_torch::fused_solve", mutates_args=(),
                         device_types="cpu")
def fused_solve_op(
    x0: torch.Tensor, D: torch.Tensor, Y: torch.Tensor, G: torch.Tensor,
    Z: torch.Tensor, V: torch.Tensor, W_f: torch.Tensor, W_b: torch.Tensor,
    W_x: torch.Tensor, const_d: torch.Tensor, lo: torch.Tensor,
    hi: torch.Tensor, dims: list[int], rho: float, max_iter: int,
    check_termination: int, warmup_iters: int, abs_pri_tol: float,
    abs_dua_tol: float, alpha: float, batch_tile: int,
) -> _Tensors8:
    """K1/K2 as a ``torch.library`` op; this body is its CPU version, the
    plain one."""
    pp = _plain_operands(W_f, W_b, W_x, lo, hi, dims, rho)
    res = fused_solve_plain(
        x0, FusedCarry(D, Y, G, Z, V), pp, max_iter=max_iter,
        check_termination=check_termination, abs_pri_tol=abs_pri_tol,
        abs_dua_tol=abs_dua_tol, warmup_iters=warmup_iters, alpha=alpha,
        const_d=const_d)
    return _op_result(res)


@fused_solve_op.register_kernel("cuda")
def _fused_solve_op_cuda(x0, D, Y, G, Z, V, W_f, W_b, W_x, const_d, lo, hi,
                         dims, rho, max_iter, check_termination, warmup_iters,
                         abs_pri_tol, abs_dua_tol, alpha, batch_tile):
    res = _launch_solve(
        x0, FusedCarry(D, Y, G, Z, V), W_f, W_b, W_x, const_d, lo, hi,
        tuple(dims), rho, max_iter=max_iter,
        check_termination=check_termination, warmup_iters=warmup_iters,
        abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol, alpha=alpha,
        batch_tile=None if batch_tile < 0 else batch_tile, threads=None,
        placement=None, register_tile=None)
    return _op_result(res)


@fused_solve_op.register_fake
def _fused_solve_op_fake(x0, D, Y, G, Z, V, W_f, W_b, W_x, const_d, lo, hi,
                         dims, rho, max_iter, check_termination, warmup_iters,
                         abs_pri_tol, abs_dua_tol, alpha, batch_tile):
    B = x0.shape[0]
    return (D.new_empty(D.shape), G.new_empty(G.shape), D.new_empty(D.shape),
            Y.new_empty(Y.shape), G.new_empty(G.shape), Z.new_empty(Z.shape),
            V.new_empty(V.shape), x0.new_empty((B, 6)))


def unpad_controls(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """First-knot controls ``(B, nu)`` from the flat U."""
    _nx, nu, _N = pp.dims
    return result.U[:, :nu]


def unpad_states(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """Full state trajectories ``(B, N, nx)`` from the flat X."""
    nx, _nu, N = pp.dims
    return result.X[:, : N * nx].reshape(result.X.shape[0], N, nx)
