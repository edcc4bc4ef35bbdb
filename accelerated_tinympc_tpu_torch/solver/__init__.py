"""Solver tiers: scan (ground truth), batched (leading batch axis + masked
early termination), condensed (dense horizon operators). The fused CUDA tier
lives in :mod:`..ops.fused_admm`."""

from . import admm  # noqa: F401
from .admm import admm_iteration, solve  # noqa: F401
from .batched import init_state_batched, solve_batched, batch_stats  # noqa: F401
from .condensed import (  # noqa: F401
    FlatProblem,
    FlatState,
    condensed_iteration,
    flat_from_state,
    flatten_problem,
    init_flat_state,
    solve_condensed,
    state_from_flat,
)
