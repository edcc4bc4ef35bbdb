"""Numerical-health utilities: NaN/Inf escapes and diverging instances,
surfaced instead of the reference's silent status codes (reference:
src/tinympc/admm.cpp:137,151). Counterpart of the JAX package's
``utils/debugging.py``.

:func:`debug_nans` is the port's counterpart of ``jax_debug_nans``: while
it is set, the solve entry points (``solver.admm.solve``,
``solver.batched.solve_batched``, ``ops.fused_admm.fused_solve``,
``ops.fused_rollout.fused_rollout``, ``ops.hetero_admm.hetero_solve``) check
their outputs and raise ``FloatingPointError`` naming the first non-finite
field. Off (the default), the entry points read one module flag and do no
reduction and no device sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from ..types import SOLVED, State

_STATE_ITERATES = ("x", "u", "d", "p", "v", "z", "y", "g")

# Set by debug_nans; read by the entry points through check_outputs.
DEBUG_NANS = False


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Scoped NaN/Inf checking of the solve entry points' outputs (see the
    module docstring); restores the previous setting on exit."""
    global DEBUG_NANS
    prev = DEBUG_NANS
    DEBUG_NANS = bool(enable)
    try:
        yield
    finally:
        DEBUG_NANS = prev


def _named_tensors(obj: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(field path, tensor)`` of every floating tensor in a result: a
    dataclass, a NamedTuple, a tuple or a tensor, in field order."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield prefix or "output", obj
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k in obj._fields:
            yield from _named_tensors(getattr(obj, k), f"{prefix}{k}.")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _named_tensors(v, f"{prefix}{i}.")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _named_tensors(getattr(obj, f.name), f"{prefix}{f.name}.")


def check_outputs(obj: Any, where: str) -> Any:
    """Return ``obj``; under :func:`debug_nans`, first raise
    ``FloatingPointError`` naming the first field of ``obj`` holding a NaN
    or an Inf. Off, it does nothing."""
    if not DEBUG_NANS:
        return obj
    for name, t in _named_tensors(obj):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"{where}: non-finite values in {name.rstrip('.')} "
                "(debug_nans is on)")
    return obj


def finite_state(state: State) -> torch.Tensor:
    """Per-instance all-finite flag over every iterate (scalar for a single
    instance, (B,) for a batch -- batch-ness read off ``state.iter``'s
    rank)."""
    batch_ndim = state.iter.dim()

    def red(a):
        axes = tuple(range(batch_ndim, a.dim()))
        fin = torch.isfinite(a)
        return fin.all(dim=axes) if axes else fin

    out = red(getattr(state, _STATE_ITERATES[0]))
    for f in _STATE_ITERATES[1:]:
        out = out & red(getattr(state, f))
    return out


def health_report(state: State) -> dict[str, Any]:
    """Host-side solve health summary: finite-ness, convergence, residuals
    -- the failure-detection surface for fleet monitoring (per-instance
    status is the recovery unit: failed instances can simply be
    re-dispatched, solves are stateless)."""
    host = lambda t: np.atleast_1d(t.detach().cpu().numpy())
    finite = host(finite_state(state))
    status = host(state.status)
    return {
        "all_finite": bool(finite.all()),
        "nonfinite_instances": np.nonzero(~finite)[0].tolist(),
        "converged_fraction": float((status == SOLVED).mean()),
        "unconverged_instances": np.nonzero(status != SOLVED)[0].tolist()[:64],
        "max_residual": float(
            max(
                np.max(host(r))
                for r in (
                    state.primal_residual_state, state.primal_residual_input,
                    state.dual_residual_state, state.dual_residual_input,
                )
            )
        ),
    }
