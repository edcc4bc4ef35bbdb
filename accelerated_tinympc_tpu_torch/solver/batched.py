"""Batched ADMM solves with per-instance early termination.

A leading batch axis over problem instances sharing one plant. Early
termination under a batch is the subtle part: per-instance convergence
diverges, and an instance's result must be identical to its single solve
(reference: src/tinympc/admm.cpp:135-144 exits without the trailing
slack-save + backward pass). One shared loop runs and converged instances
are *frozen* with a field-wide select, until every instance converged or hit
``max_iter``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..types import (
    DEFAULT_DEVICE, SOLVED, UNSOLVED, Cache, Problem, Settings, State,
    init_state,
)
from .admm import _select, admm_iteration

# Shared-vs-batched problem/cache data.
SHARED = None
BATCHED = 0


def init_state_batched(
    batch: int, nx: int, nu: int, horizon: int, dtype: Any = torch.float32,
    device: Any = DEFAULT_DEVICE,
) -> State:
    """Cold-start batched state: batch axis leading on every field."""
    single = init_state(nx, nu, horizon, dtype, device)
    return State(**{
        k: a.expand((batch,) + tuple(a.shape)).clone()
        for k, a in single.tensors().items()
    })


def solve_batched(
    state: State,
    problem: Problem,
    cache: Cache,
    settings: Settings,
    *,
    problem_axes=SHARED,
    cache_axes=SHARED,
    project=None,
    forward=None,
    backward=None,
) -> State:
    """Solve a batch of instances; each instance's trajectory through the
    ADMM loop is identical to its standalone :func:`..solver.admm.solve`.

    Problem and cache are shared by the batch ("thousands of perturbed
    scenarios, one plant"); per-instance plants (``problem_axes=BATCHED``)
    arrive with the fleet tiers. With ``check_termination == 0`` this is a
    fixed-iteration loop over the whole batch.
    """
    if problem_axes is not SHARED or cache_axes is not SHARED:
        raise NotImplementedError(
            "per-instance problem/cache data (problem_axes=BATCHED) comes "
            "with the per-instance-plant slices of ROADMAP.md (8-9)")
    with torch.no_grad():
        iterate = lambda s: admm_iteration(
            s, problem, cache, settings,
            project=project, forward=forward, backward=backward,
        )
        state = state.replace(
            status=torch.full_like(state.status, UNSOLVED),
            iter=torch.zeros_like(state.iter),
        )
        if settings.check_termination <= 0:
            for _ in range(settings.max_iter):
                state = iterate(state)
            return state
        for _ in range(settings.max_iter):
            done = state.status == SOLVED
            if bool(done.all()):
                break
            state = _select(done, state, iterate(state))
        return state


def batch_stats(state: State, settings: Settings) -> dict[str, torch.Tensor]:
    """Structured per-batch solve metrics (residual/iter fields per
    reference src/tinympc/types.hpp:76-81)."""
    converged = state.status == SOLVED
    return {
        "converged_fraction": converged.to(torch.float32).mean(),
        "iterations_mean": state.iter.to(torch.float32).mean(),
        "iterations_max": state.iter.max(),
        "primal_residual_state_max": state.primal_residual_state.max(),
        "primal_residual_input_max": state.primal_residual_input.max(),
        "dual_residual_state_max": state.dual_residual_state.max(),
        "dual_residual_input_max": state.dual_residual_input.max(),
    }
