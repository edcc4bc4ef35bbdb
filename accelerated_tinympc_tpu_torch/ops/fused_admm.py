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
N=129.

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
instantiations of the three kernels (``cone_stage`` in
``csrc/admm_iteration.cuh``), one thread per (instance, knot).

Beside the kernel sits :func:`fused_solve_plain`, batched tensor code that
repeats the kernel's arithmetic stage by stage. :func:`fused_solve` takes it
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..precompute import CondensedOperators
from ..types import DEFAULT_DEVICE, Cache, Problem, _Struct

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
}

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

def _iteration(D, Y, G, Z, V, pp: PaddedProblem, Xb, Ub, const_d, alpha,
               cone_u=None, cone_x=None):
    """One folded condensed ADMM iteration on ``(B, .)`` tensors -- the
    arithmetic of the kernel's forward/clip/dual/backward stages. Stage order
    is the reference's (src/tinympc/admm.cpp:117-150). ``cone_u``/``cone_x``
    project the clipped slacks onto the cones (composition after the box
    clip, as :func:`..solver.cones.cone_slack_update`)."""
    X = Xb + torch.matmul(D, pp.W_fd)
    U = Ub + torch.matmul(D, pp.W_gd)
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
    Dn = (torch.matmul(Vnew - Gn, pp.W_q)
          + torch.matmul(Znew - Yn, pp.W_r) + const_d)
    return Dn, Yn, Gn, Znew, Vnew, U, X


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
) -> FusedResult:
    """Plain PyTorch version of the fused solve (fixed and adaptive): the
    kernel's arithmetic, stage by stage, on whole-batch tensors. Runs on any
    device and in float32 or float64. ``const_d`` (``(1, Du)``) gives the
    folded reference constant directly, as the rollout streams it. The cone
    arguments are those of :func:`fused_solve`."""
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
        step = lambda D, Y, G, Z, V: _iteration(
            D, Y, G, Z, V, pp, Xb, Ub, const_d, alpha, cone_u, cone_x)
        stats = torch.zeros((B, 6), dtype=x0.dtype, device=x0.device)

        if check_termination <= 0:
            for _ in range(max_iter - 1):
                D, Y, G, Z, V, _U, _X = step(D, Y, G, Z, V)
            Dn, Yn, Gn, Znew, Vnew, U, X = step(D, Y, G, Z, V)
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
            Dn, Yn, Gn, Znew, Vnew, Un, Xn = step(D, Y, G, Z, V)
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

def kernel_smem_bytes(nx: int, nu: int, horizon: int, tile: int,
                      ncp: int = 0, placement: str = "shared") -> int:
    """Dynamic shared memory one block needs: mirrors ``make_layout`` in
    ``csrc/admm_iteration.cuh`` (the C entry refuses a launch when the two
    disagree). ``ncp`` is the number of cones with per-instance mu/shift
    rows (0 for static cone parameters and for box-only solves): the coned
    kernels need nothing else beyond the box layout. ``placement="device"``
    leaves the operators Wf, Wb, Wx out (the kernels read them from device
    memory)."""
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
    return 4 * words


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
                     ncp: int = 0) -> str:
    """Where the kernels keep the condensed operators: ``"shared"`` wherever
    they fit beside one register tile of 8 slots (every shape that ran
    before the device placement keeps its kernel), else ``"device"`` (read
    from device memory, resident in L2) while one register tile of per-slot
    state fits, of 8 slots or else of 4. Raises past that, with the bytes
    needed."""
    nx, nu, N = dims
    if kernel_smem_bytes(nx, nu, N, REGISTER_TILE, ncp) <= limit:
        return "shared"
    need = kernel_smem_bytes(nx, nu, N, REGISTER_TILES[-1], ncp, "device")
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
                         ncp: int = 0, placement: str | None = None) -> int:
    """Slots per register tile at ``placement`` (default
    :func:`choose_placement`): 8 wherever one such tile fits (every shape
    that ran before keeps its kernel), else 4, which only the device
    placement takes. Raises if neither fits."""
    nx, nu, N = dims
    if placement is None:
        placement = choose_placement(dims, limit, ncp)
    for ri in REGISTER_TILES:
        if ri != REGISTER_TILE and placement != "device":
            break
        if kernel_smem_bytes(nx, nu, N, ri, ncp, placement) <= limit:
            return ri
    need = kernel_smem_bytes(nx, nu, N, ri, ncp, placement)
    raise ValueError(
        f"one register tile of {ri} slots at nx={nx}, nu={nu}, horizon={N} "
        f"needs {need} bytes of shared memory with the operators in "
        f"{placement} memory (limit {limit})")


def choose_tile(dims: tuple, batch: int, n_sm: int = 132,
                limit: int = SMEM_LIMIT_BYTES, ncp: int = 0,
                placement: str | None = None,
                register_tile: int | None = None) -> int:
    """Slots per block: the largest multiple of the register tile that fits
    shared memory, not more than spreads the batch over all SMs, at
    ``placement`` (default: :func:`choose_placement`, which raises if even
    one register tile does not fit) and ``register_tile`` slots per register
    tile (default: :func:`choose_register_tile`)."""
    nx, nu, N = dims
    if placement is None:
        placement = choose_placement(dims, limit, ncp)
    ri = register_tile or choose_register_tile(dims, limit, ncp, placement)
    if ri not in REGISTER_TILES or (ri != REGISTER_TILE
                                    and placement != "device"):
        raise ValueError(f"register tiles of {ri} slots: take 8, or 4 with "
                         "the operators in device memory")
    need = kernel_smem_bytes(nx, nu, N, ri, ncp, placement)
    if need > limit:
        raise ValueError(
            f"one register tile of {ri} slots at nx={nx}, nu={nu}, "
            f"horizon={N} needs {need} bytes of shared memory with the "
            f"operators in {placement} memory (limit {limit})")
    fit = ri
    while (fit + ri <= MAX_TILE and
           kernel_smem_bytes(nx, nu, N, fit + ri, ncp, placement) <= limit):
        fit += ri
    per_sm = -(-batch // n_sm)
    want = -(-per_sm // ri) * ri
    return max(ri, min(fit, want))


_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _library() -> ctypes.CDLL:
    """Load (building at first use) the kernels and declare their C
    signatures; every pointer and the stream are ``c_void_p``."""
    from ._build import load_library

    lib = load_library("fused_admm")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_fused_smem_bytes.argtypes = [_I] * 6
        lib.atm_fused_smem_bytes.restype = _I
        lib.atm_fused_solve.argtypes = (
            [_P] * 22 + [_I] * 2 + [_P] * 3 + [_I] * 7 + [_F] * 4 + [_I] * 5
            + [_P])
        lib.atm_fused_solve.restype = _I
        lib.atm_fused_rollout.argtypes = (
            [_P] * 25 + [_I] * 2 + [_P] + [_I] * 9 + [_F] * 4 + [_I] * 5
            + [_P])
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


def _kernel_operands(pp: PaddedProblem, device) -> tuple:
    """Wf, Wb, Wx (padded, :class:`PaddedProblem`), lo, hi, checked."""
    nx, nu, N = pp.dims
    r4 = lambda n: (n + 3) & ~3
    Du, Dz = pp.Du, pp.Dx + pp.Du
    DuP, DzP = r4(Du), r4(Dz)
    return (
        _check("pp.W_f", pp.W_f, (DuP, DzP), device),
        _check("pp.W_b", pp.W_b, (DzP, DuP), device),
        _check("pp.W_x", pp.W_x, (nx, DzP), device),
        _check("pp.lo", pp.lo, (Dz,), device),
        _check("pp.hi", pp.hi, (Dz,), device),
    )


def _geometry(pp: PaddedProblem, B: int, device, batch_tile, threads,
              ncp: int = 0, placement: str | None = None,
              register_tile: int | None = None):
    """``(tile, threads, smem bytes, placement, register tile)`` of one
    launch; the placement is :func:`choose_placement`'s and the register
    tile :func:`choose_register_tile`'s unless given."""
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    nx, nu, N = pp.dims
    if placement is None:
        placement = choose_placement(pp.dims, limit, ncp)
    ri = register_tile or choose_register_tile(pp.dims, limit, ncp, placement)
    if batch_tile is None:
        tile = choose_tile(pp.dims, B, props.multi_processor_count, limit, ncp,
                           placement, ri)
    else:
        tile = max(ri, -(-int(batch_tile) // ri) * ri)
        tile = min(tile, choose_tile(pp.dims, 10 ** 9, 1, limit, ncp,
                                     placement, ri))
    if threads is None:
        threads = (MAX_THREADS if ri != REGISTER_TILE
                   else min(MAX_THREADS, THREADS_PER_INSTANCE * tile))
    threads = max(int(threads), -(-tile // 32) * 32)
    return (tile, threads, kernel_smem_bytes(nx, nu, N, tile, ncp, placement),
            placement, ri)


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


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(
            f"{what}: launch geometry refused (shared-memory layout of the "
            "wrapper and the kernel disagree, or tile/threads out of range)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _unsupported(algo, polish) -> None:
    if algo == "bf16x3":
        raise NotImplementedError(
            "algo='bf16x3' is the TPU's split-operand MXU mode; its Hopper "
            "counterpart (a split-operand tensor-core mode) comes with the "
            "'Hopper arithmetic modes for K1-K3' item of ROADMAP.md")
    if algo != "f32":
        raise ValueError(f"unknown algo {algo!r}; use 'f32'")


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

    Tensors on the CPU go through :func:`fused_solve_plain`; tensors on a
    CUDA device launch the kernel (float32 only) or raise. ``algo='bf16x3'``
    raises ``NotImplementedError`` for now (``polish`` is that mode's knob
    and is not read).
    """
    _unsupported(algo, polish)
    if max_iter < 1:
        raise ValueError("the fused tier runs at least one iteration; "
                         "use the scan tier for max_iter=0")
    if not x0.is_cuda:
        return fused_solve_plain(
            x0, carry, pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            warmup_iters=warmup_iters, xref_q=xref_q, pterm_c=pterm_c,
            alpha=alpha, cone_ops=cone_ops,
            cone_mu_u=cone_mu_u, cone_shift_u=cone_shift_u,
            cone_mu_x=cone_mu_x, cone_shift_x=cone_shift_x,
        )

    nx, nu, N = pp.dims
    Dx, Du = pp.Dx, pp.Du
    B = x0.shape[0]
    dev = x0.device
    mu_rows, shift_rows = _cone_rows(
        cone_ops, cone_mu_u, cone_shift_u, cone_mu_x, cone_shift_x, B)
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
    with torch.no_grad():
        const_d = _check("const_d", fold_const_d(pp, xref_q, pterm_c),
                         (1, Du), dev)
    tile, threads, smem, placement, ri = _geometry(
        pp, B, dev, batch_tile, threads, ncp, placement, register_tile)
    W_f, W_b, W_x, lo, hi = _kernel_operands(pp, dev)

    new = lambda w: torch.empty((B, w), dtype=torch.float32, device=dev)
    U, X, D, Y, G, Z, V = (new(Du), new(Dx), new(Du), new(Du), new(Dx),
                           new(Du), new(Dx))
    stats = new(6)
    adaptive = check_termination > 0
    counter = work_counter(dev)
    lib = _library()
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
            counter.data_ptr(),
            B, nx, nu, N, int(max_iter),
            int(check_termination) if adaptive else 0,
            min(int(warmup_iters), int(max_iter) - 1) if adaptive else 0,
            float(pp.rho_f), float(alpha),
            float(abs_pri_tol), float(abs_dua_tol),
            tile, threads, smem, int(placement == "device"), ri, stream,
        )
    _raise_on(err, "fused_solve")
    LAUNCH_COUNTS[
        ("fused_solve_adaptive" if adaptive else "fused_solve_fixed")
        + ("_cones" if coned else "")] += 1
    return FusedResult(
        U=U, X=X, carry=FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), stats=stats)


def unpad_controls(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """First-knot controls ``(B, nu)`` from the flat U."""
    _nx, nu, _N = pp.dims
    return result.U[:, :nu]


def unpad_states(result: FusedResult, pp: PaddedProblem) -> torch.Tensor:
    """Full state trajectories ``(B, N, nx)`` from the flat X."""
    nx, _nu, N = pp.dims
    return result.X[:, : N * nx].reshape(result.X.shape[0], N, nx)
