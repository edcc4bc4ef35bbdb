"""Condensed-operator ADMM: both horizon sweeps as dense products.

Both horizon sweeps of the reference's ADMM iteration are affine recurrences
(forward rollout -- reference: src/tinympc/admm.cpp:27-37; backward Riccati
gradient recursion -- src/tinympc/admm.cpp:15-22), so each sweep collapses
into a dense product against precomputed operators
(:func:`..precompute.condensed_operators`). For a batch ``B`` the
per-iteration hot path is a handful of ``(B, n) @ (n, m)`` products instead
of ``2*(N-1)`` dependent small matvecs. This is the flat layout the fused
CUDA kernels (:mod:`..ops.fused_admm`) realize.

State layout is *flat and batch-leading*: ``X/V/G/Q (B, N*nx)``,
``U/Z/Y/R/D (B, (N-1)*nu)``, time-major within the flattened axis. The math
is the same schedule as :mod:`.admm` (same stage order, warm start,
early-exit semantics, replicated reference quirks); only the sweep
realization differs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..precompute import CondensedOperators
from ..types import (
    DEFAULT_DEVICE, SOLVED, UNSOLVED, Cache, Problem, Settings, State,
    _Struct,
)

torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 products


def _mm(a: torch.Tensor, bT: torch.Tensor) -> torch.Tensor:
    """(B, k) @ (k, n) in the working precision."""
    return torch.matmul(a, bT)


@dataclasses.dataclass(frozen=True)
class FlatState(_Struct):
    """Flattened batched ADMM iterate set. Fields ``(B, N*nx)`` /
    ``(B, m*nu)`` except residuals/status/iter ``(B,)``. ``x0`` is the
    (fixed-per-solve) measured state, ``(B, nx)``."""

    x0: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    P: torch.Tensor
    D: torch.Tensor
    V: torch.Tensor
    Vnew: torch.Tensor
    Z: torch.Tensor
    Znew: torch.Tensor
    G: torch.Tensor
    Y: torch.Tensor
    primal_residual_state: torch.Tensor
    primal_residual_input: torch.Tensor
    dual_residual_state: torch.Tensor
    dual_residual_input: torch.Tensor
    status: torch.Tensor
    iter: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlatProblem(_Struct):
    """Problem data flattened to the condensed layout. The cost diagonal is
    tiled over the horizon (``Qh (N*nx,)``; the reference drops the Uref cost
    term, src/tinympc/admm.cpp:79)."""

    Qh: torch.Tensor          # (N*nx,) diag Q tiled over knots
    Xref: torch.Tensor        # (N*nx,)
    XrefPinf_T: torch.Tensor  # (nx,) terminal reference through Pinf
    x_min: torch.Tensor       # (N*nx,)
    x_max: torch.Tensor
    u_min: torch.Tensor       # (m*nu,)
    u_max: torch.Tensor
    rho: torch.Tensor


def flatten_problem(problem: Problem, cache: Cache) -> FlatProblem:
    """Flatten time-major Problem arrays into the condensed layout. The
    terminal-cost projection ``-Xref[-1] @ Pinf`` (reference:
    src/tinympc/admm.cpp:83) is hoisted here: it depends only on problem
    data, not on iterates."""
    N = problem.Xref.shape[-2]
    return FlatProblem(
        Qh=problem.Q.repeat(N),
        Xref=problem.Xref.reshape(-1),
        XrefPinf_T=torch.matmul(problem.Xref[-1], cache.Pinf),
        x_min=problem.x_min.reshape(-1),
        x_max=problem.x_max.reshape(-1),
        u_min=problem.u_min.reshape(-1),
        u_max=problem.u_max.reshape(-1),
        rho=cache.rho,
    )


def init_flat_state(
    batch: int, nx: int, nu: int, horizon: int, dtype: Any = torch.float32,
    device: Any = DEFAULT_DEVICE,
) -> FlatState:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    fx, fu, sc = z(batch, horizon * nx), z(batch, (horizon - 1) * nu), z(batch)
    iz = torch.zeros((batch,), dtype=torch.int32, device=device)
    return FlatState(
        x0=z(batch, nx),
        X=fx, U=fu, Q=fx, R=fu, P=fx, D=fu,
        V=fx, Vnew=fx, Z=fu, Znew=fu, G=fx, Y=fu,
        primal_residual_state=sc, primal_residual_input=sc,
        dual_residual_state=sc, dual_residual_input=sc,
        status=iz, iter=iz,
    )


def _select_flat(mask: torch.Tensor, a: FlatState, b: FlatState) -> FlatState:
    out = {}
    for name, ta in a.tensors().items():
        m = mask.reshape(mask.shape + (1,) * (ta.dim() - 1))
        out[name] = torch.where(m, ta, getattr(b, name))
    return FlatState(**out)


def condensed_iteration(
    s: FlatState,
    fp: FlatProblem,
    ops: CondensedOperators,
    settings: Settings,
    nx: int,
    *,
    cones=None,
    nu: int | None = None,
) -> FlatState:
    """One ADMM iteration, condensed. Mirrors reference
    src/tinympc/admm.cpp:117-150 stage order exactly; see :mod:`.admm` for
    the semantics being reproduced. ``cones`` (second-order-cone
    projections after the box clip) are not ported yet."""
    if cones is not None:
        raise NotImplementedError(
            "cones on the condensed tier come with ROADMAP.md slice 6")
    s = s.replace(iter=s.iter + 1)

    # --- forward pass: X = x0 Fx0^T + D Fd^T; U = x0 Gx0^T + D Gd^T ----------
    X = _mm(s.x0, ops.Fx0.T) + _mm(s.D, ops.Fd.T)
    U = _mm(s.x0, ops.Gx0.T) + _mm(s.D, ops.Gd.T)

    # --- slack projection (reference: admm.cpp:45-61) ------------------------
    # alpha != 1: the slack/dual stages see the relaxed iterate; the true
    # iterates (and residual definitions below) are untouched.
    if settings.alpha != 1.0:
        a = settings.alpha
        Ur = a * U + (1.0 - a) * s.Z
        Xr = a * X + (1.0 - a) * s.V
    else:
        Ur, Xr = U, X
    Znew = Ur + s.Y
    Vnew = Xr + s.G
    if settings.en_input_bound:
        Znew = torch.minimum(fp.u_max, torch.maximum(fp.u_min, Znew))
    if settings.en_state_bound:
        Vnew = torch.minimum(fp.x_max, torch.maximum(fp.x_min, Vnew))

    # --- dual ascent (admm.cpp:67-71; relaxed iterates when alpha != 1) ------
    Y = s.Y + Ur - Znew
    G = s.G + Xr - Vnew

    # --- linear cost refresh (admm.cpp:77-85) --------------------------------
    R = -fp.rho * (Znew - Y)
    Q = -(fp.Xref * fp.Qh) - fp.rho * (Vnew - G)
    p_term = -fp.XrefPinf_T - fp.rho * (Vnew[:, -nx:] - G[:, -nx:])
    P = s.P.clone()
    P[:, -nx:] = p_term
    s = s.replace(X=X, U=U, Znew=Znew, Vnew=Vnew, Y=Y, G=G, R=R, Q=Q, P=P)

    # --- termination (admm.cpp:91-109) ---------------------------------------
    converged = None
    if settings.check_termination > 0:
        do_check = (s.iter % settings.check_termination) == 0
        pri_s = (s.X - s.Vnew).abs().amax(dim=-1)
        dua_s = (s.V - s.Vnew).abs().amax(dim=-1) * fp.rho
        pri_u = (s.U - s.Znew).abs().amax(dim=-1)
        dua_u = (s.Z - s.Znew).abs().amax(dim=-1) * fp.rho
        keep = lambda new, old: torch.where(do_check, new, old)
        s = s.replace(
            primal_residual_state=keep(pri_s, s.primal_residual_state),
            dual_residual_state=keep(dua_s, s.dual_residual_state),
            primal_residual_input=keep(pri_u, s.primal_residual_input),
            dual_residual_input=keep(dua_u, s.dual_residual_input),
        )
        converged = do_check & (
            (pri_s < settings.abs_pri_tol)
            & (pri_u < settings.abs_pri_tol)
            & (dua_s < settings.abs_dua_tol)
            & (dua_u < settings.abs_dua_tol)
        )

    # --- slack save + backward pass, masked out on convergence ----------------
    # P = Qhead Hq^T + R Hr^T + p_term Hp^T; D likewise with Eq/Er/Ep.
    Qhead = Q[:, :-nx]
    P_new = _mm(Qhead, ops.Hq.T) + _mm(R, ops.Hr.T) + _mm(p_term, ops.Hp.T)
    D_new = _mm(Qhead, ops.Eq.T) + _mm(R, ops.Er.T) + _mm(p_term, ops.Ep.T)
    advanced = s.replace(V=s.Vnew, Z=s.Znew, P=P_new, D=D_new)
    if converged is None:
        return advanced
    s = _select_flat(converged, s, advanced)
    status = torch.where(
        converged, torch.full_like(s.status, SOLVED), s.status)
    return s.replace(status=status)


def solve_condensed(
    s: FlatState,
    fp: FlatProblem,
    ops: CondensedOperators,
    settings: Settings,
    nx: int,
    *,
    cones=None,
    nu: int | None = None,
) -> FlatState:
    """Condensed batched ADMM loop; same freeze-on-converge semantics as
    :func:`.batched.solve_batched`."""
    if cones is not None:
        raise NotImplementedError(
            "cones on the condensed tier come with ROADMAP.md slice 6")
    with torch.no_grad():
        step = lambda st: condensed_iteration(st, fp, ops, settings, nx)
        s = s.replace(
            status=torch.full_like(s.status, UNSOLVED),
            iter=torch.zeros_like(s.iter),
        )
        if settings.check_termination <= 0:
            for _ in range(settings.max_iter):
                s = step(s)
            return s
        for _ in range(settings.max_iter):
            done = s.status == SOLVED
            if bool(done.all()):
                break
            s = _select_flat(done, s, step(s))
        return s


# --- conversions to/from the time-major State layout -------------------------

def flat_from_state(state: State, nx: int, nu: int) -> FlatState:
    """Convert a batched time-major :class:`..types.State` into FlatState."""
    B = state.x.shape[0]
    fl = lambda a: a.reshape(B, -1)
    return FlatState(
        x0=state.x[:, 0, :],
        X=fl(state.x), U=fl(state.u), Q=fl(state.q), R=fl(state.r),
        P=fl(state.p), D=fl(state.d), V=fl(state.v), Vnew=fl(state.vnew),
        Z=fl(state.z), Znew=fl(state.znew), G=fl(state.g), Y=fl(state.y),
        primal_residual_state=state.primal_residual_state,
        primal_residual_input=state.primal_residual_input,
        dual_residual_state=state.dual_residual_state,
        dual_residual_input=state.dual_residual_input,
        status=state.status, iter=state.iter,
    )


def state_from_flat(s: FlatState, nx: int, nu: int, horizon: int) -> State:
    """Convert FlatState back to the batched time-major State layout."""
    B = s.X.shape[0]
    un_x = lambda a: a.reshape(B, horizon, nx)
    un_u = lambda a: a.reshape(B, horizon - 1, nu)
    # Solver-internal X keeps the rolled-out first knot; restore measured x0.
    x = un_x(s.X).clone()
    x[:, 0, :] = s.x0
    return State(
        x=x, u=un_u(s.U), q=un_x(s.Q), r=un_u(s.R), p=un_x(s.P), d=un_u(s.D),
        v=un_x(s.V), vnew=un_x(s.Vnew), z=un_u(s.Z), znew=un_u(s.Znew),
        g=un_x(s.G), y=un_u(s.Y),
        primal_residual_state=s.primal_residual_state,
        primal_residual_input=s.primal_residual_input,
        dual_residual_state=s.dual_residual_state,
        dual_residual_input=s.dual_residual_input,
        status=s.status, iter=s.iter,
    )
