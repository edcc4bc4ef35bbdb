"""Batched ADMM solves with per-instance early termination.

A leading batch axis over problem instances, sharing one plant or each
with its own (``problem_axes``/``cache_axes``). Early
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
from ..utils.debugging import check_outputs
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

    ``problem_axes``/``cache_axes`` select shared (``SHARED``: "thousands of
    perturbed scenarios, one plant") or per-instance (``BATCHED``: every
    field has a leading batch axis -- the random-plant sweep, the fleet's
    ``tier="scan"``) problem data; the stages of :mod:`.admm` broadcast over
    either. With ``check_termination == 0`` this is a fixed-iteration loop
    over the whole batch.
    """
    for axes in (problem_axes, cache_axes):
        if axes not in (SHARED, BATCHED):
            raise ValueError(f"axes must be SHARED (None) or BATCHED (0), "
                             f"got {axes!r}")
    if problem_axes == BATCHED and problem.A.dim() != 3:
        raise ValueError("problem_axes=BATCHED needs batch-leading problem "
                         "fields (A of shape (B, nx, nx))")
    if cache_axes == BATCHED and cache.Kinf.dim() != 3:
        raise ValueError("cache_axes=BATCHED needs batch-leading cache "
                         "fields (Kinf of shape (B, nu, nx))")
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
            return check_outputs(state, "solve_batched")
        for _ in range(settings.max_iter):
            done = state.status == SOLVED
            if bool(done.all()):
                break
            state = _select(done, state, iterate(state))
        return check_outputs(state, "solve_batched")


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
