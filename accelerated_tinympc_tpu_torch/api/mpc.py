"""Receding-horizon MPC rollouts.

The reference's MPC loop is host-side: per tick it sets ``x.col(0)``, zeroes
duals, calls ``tiny_solve``, applies ``u.col(0)`` and steps the plant
(reference: examples/quadrotor_hovering.cpp:90-114, quadrotor_tracking.cpp:
93-117). :func:`mpc_rollout` runs that loop on the plain tiers;
:func:`fused_mpc_rollout` runs it on the fused CUDA tier, either as a Python
tick loop over one kernel launch per tick or (``in_kernel=True``) as one
launch for the whole mission.

Works single-instance or batched (scenario MPC: one plant, thousands of
perturbed instances) -- state/x0 just carry a leading batch axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..solver import admm
from ..solver.batched import init_state_batched, solve_batched
from ..types import Cache, Problem, Settings, State, init_state, reset_duals


class MPCTrace(NamedTuple):
    """Per-tick outputs of a rollout. ``x`` is the *plant* state at each tick
    (pre-solve measurement), ``u`` the applied first-knot control, matching
    what the reference examples print (quadrotor_hovering.cpp:92,110)."""

    x: torch.Tensor        # (T, [batch,] nx)
    u: torch.Tensor        # (T, [batch,] nu)
    iters: torch.Tensor    # (T, [batch]) int32
    status: torch.Tensor   # (T, [batch]) int32


def default_plant(
    problem: Problem,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Nominal LTI plant x+ = A x + B u (reference:
    examples/quadrotor_hovering.cpp:110)."""

    def step(x, u):
        return torch.matmul(x, problem.A.T) + torch.matmul(u, problem.B.T)

    return step


def mpc_rollout(
    problem: Problem,
    cache: Cache,
    settings: Settings,
    x0: torch.Tensor,
    n_ticks: int,
    *,
    Xref_total: torch.Tensor | None = None,
    state: State | None = None,
    plant: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    batched: bool = False,
    solver: Callable[[State, Problem], State] | None = None,
) -> tuple[State, torch.Tensor, MPCTrace]:
    """Run ``n_ticks`` of receding-horizon MPC on the plain tiers.

    With ``Xref_total`` (shape ``(T >= n_ticks + N, nx)``) the horizon window
    slides each tick (tracking mode); otherwise ``problem.Xref`` is constant
    (hovering mode). Returns (final solver state, final plant state, trace).
    ``solver`` overrides the per-tick solve (``(state, problem) -> state``,
    scan-tier semantics).

    Per-tick semantics match the reference loop exactly: duals reset,
    slacks/gains warm-started, *pre-projection* first-knot u applied to the
    plant.
    """
    N = problem.horizon
    nx, nu = problem.nx, problem.nu
    plant_step = plant or default_plant(problem)
    solver = solver or (
        (lambda s, p: solve_batched(s, p, cache, settings))
        if batched
        else (lambda s, p: admm.solve(s, p, cache, settings))
    )
    dtype, device = problem.A.dtype, problem.A.device
    with torch.no_grad():
        x = torch.as_tensor(x0, dtype=dtype, device=device)
        if state is None:
            state = (
                init_state_batched(x.shape[0], nx, nu, N, dtype, device)
                if batched else init_state(nx, nu, N, dtype, device)
            )
        if Xref_total is not None:
            Xref_total = torch.as_tensor(
                Xref_total, dtype=dtype, device=device)
        xs, us, iters, status = [], [], [], []
        for k in range(int(n_ticks)):
            prob = problem
            if Xref_total is not None:
                prob = prob.replace(Xref=Xref_total[k:k + N])
            st = reset_duals(state)
            sx = st.x.clone()
            sx[..., 0, :] = x
            state = solver(st.replace(x=sx), prob)
            u0 = state.u[..., 0, :]
            xs.append(x)
            us.append(u0)
            iters.append(state.iter)
            status.append(state.status)
            x = plant_step(x, u0)
        trace = MPCTrace(
            x=torch.stack(xs), u=torch.stack(us),
            iters=torch.stack(iters), status=torch.stack(status),
        )
    return state, x, trace


def tracking_error(trace: MPCTrace, Xref_total: torch.Tensor) -> torch.Tensor:
    """Per-tick L2 tracking error vs the reference trajectory -- the metric
    the reference examples print each tick (quadrotor_tracking.cpp:95)."""
    T = trace.x.shape[0]
    ref = torch.as_tensor(
        Xref_total, dtype=trace.x.dtype, device=trace.x.device)[:T]
    if trace.x.dim() == 3:  # batched
        ref = ref[:, None, :]
    return torch.linalg.norm(trace.x - ref, dim=-1)


def fused_mpc_rollout(
    pp,
    x0: torch.Tensor,
    n_ticks: int,
    *,
    problem: Problem,
    max_iter: int = 100,
    batch_tile: int | None = None,
    carry=None,
    Xref_total: torch.Tensor | None = None,
    Pinf: torch.Tensor | None = None,
    cone_ops=None,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    algo: str = "f32",
    polish: int = 8,
    in_kernel: bool = False,
    alpha: float = 1.0,
):
    """Receding-horizon rollout on the fused tier: ``n_ticks`` of (dual reset
    -> fused solve -> apply pre-projection u0 -> plant step).

    ``pp`` is a :class:`..ops.fused_admm.PaddedProblem`; ``x0`` is
    ``(B, nx)``. With ``Xref_total`` (and the cache's ``Pinf``) the horizon
    window slides each tick (tracking mode -- the reference-dependent solve
    operands are recomputed with :func:`..ops.fused_admm.ref_vectors`).
    Returns ``(x_final, u0_trace (n_ticks, B, nu), carry)`` with warm-start
    carries matching the reference tick protocol (duals reset, slacks kept
    -- reference: examples/quadrotor_hovering.cpp:99-104).

    ``check_termination > 0`` runs each tick's solve in the adaptive kernel
    (the reference's own per-tick early exit). ``in_kernel=False`` is a
    Python tick loop with one solve launch per tick; ``in_kernel=True`` runs
    the whole mission in one launch
    (:func:`..ops.fused_rollout.fused_rollout`). Cones raise for now.
    """
    from ..ops.fused_admm import (
        FusedCarry, fused_solve, ref_vectors, unpad_controls,
    )

    if carry is None:
        carry = FusedCarry.zeros(x0.shape[0], pp, x0.dtype, x0.device)
    if Xref_total is not None and Pinf is None:
        raise ValueError("tracking mode needs the cache Pinf for ref_vectors")
    N = problem.horizon
    if Xref_total is not None:
        Xref_total = torch.as_tensor(
            Xref_total, dtype=x0.dtype, device=x0.device)

    if in_kernel:
        from ..ops.fused_rollout import (
            fused_rollout, rollout_const_seq, rollout_ops,
        )
        const_seq = None
        if Xref_total is not None:
            const_seq = rollout_const_seq(
                pp, problem.Q, Pinf, Xref_total, n_ticks)
        res = fused_rollout(
            x0, carry, pp,
            rollout_ops(problem, pp, x0.dtype, x0.device), n_ticks,
            max_iter=max_iter, check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            batch_tile=batch_tile, const_seq=const_seq, algo=algo,
            polish=polish, cone_ops=cone_ops, alpha=alpha,
        )
        return res.x_final, res.us, res.final.carry

    with torch.no_grad():
        x = x0
        A_T, B_T = problem.A.T, problem.B.T
        us = []
        for k in range(int(n_ticks)):
            refs = {}
            if Xref_total is not None:
                xref_q, pterm_c = ref_vectors(
                    pp, problem.Q, Pinf, Xref_total[k:k + N])
                refs = {"xref_q": xref_q, "pterm_c": pterm_c}
            res = fused_solve(
                x, carry.reset_duals(), pp, max_iter=max_iter,
                check_termination=check_termination,
                abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
                batch_tile=batch_tile, algo=algo, polish=polish,
                alpha=alpha, cone_ops=cone_ops, **refs,
            )
            carry = res.carry
            u0 = unpad_controls(res, pp)
            us.append(u0)
            x = torch.matmul(x, A_T) + torch.matmul(u0, B_T)
    return x, torch.stack(us), carry
