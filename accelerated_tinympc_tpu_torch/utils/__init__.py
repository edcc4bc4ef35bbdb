"""Serialization, profiling, and observability utilities."""

from .serialization import (  # noqa: F401
    load_like,
    load_problem_cache,
    save_problem_cache,
    save_pytree,
)
from .profiling import (  # noqa: F401
    hetero_cost,
    solver_cost,
    stream_cost,
    time_fn,
    trace,
)
from .debugging import debug_nans, finite_state, health_report  # noqa: F401
