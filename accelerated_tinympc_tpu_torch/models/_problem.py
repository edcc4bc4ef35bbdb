"""Shared constructor for the model setups: numpy arrays in, a
:class:`..types.Problem` of tensors on the requested device out."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..types import Problem


def make_problem(
    A, B, Q, R, horizon: int, *,
    u_bound: float, x_bound: float, Xref=None,
    dtype: Any = torch.float32, device: Any = "cuda",
) -> Problem:
    """Problem with constant symmetric box bounds and an optional reference
    window (zeros by default)."""
    B = np.asarray(B, np.float64)
    nx, nu = B.shape
    N, m = horizon, horizon - 1
    if Xref is None:
        Xref = np.zeros((N, nx))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)
    return Problem(
        A=t(A), B=t(B), Q=t(Q), R=t(R),
        u_min=full((m, nu), -u_bound), u_max=full((m, nu), u_bound),
        x_min=full((N, nx), -x_bound), x_max=full((N, nx), x_bound),
        Xref=t(Xref),
        Uref=torch.zeros((m, nu), dtype=dtype, device=device),
    )
