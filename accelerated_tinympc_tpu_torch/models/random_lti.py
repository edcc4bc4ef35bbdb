"""Randomized dense LTI problem generator -- the stress family for sweeping
(nx, nu, N) kernel shapes (reference: examples/codegen_random.cpp,
generalized to batched random plants).

Plants are sampled to be stabilizable and mildly damped so the
infinite-horizon Riccati fixed point converges: A = I + dt * M with
M ~ N(0, 1/sqrt(nx)) scaled to spectral radius <= ~1.05,
B ~ N(0, 1)/sqrt(nx). The draws come from numpy's ``default_rng(seed)`` in
the same order as the JAX package's generator, so one seed gives one plant
in both.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..types import Problem
from ._problem import make_problem


def random_lti_problem(
    seed: int,
    nx: int,
    nu: int,
    horizon: int,
    *,
    dt: float = 0.05,
    q_scale: float = 10.0,
    r_scale: float = 1.0,
    bound: float = 3.0,
    dtype: Any = torch.float32,
    device: Any = "cuda",
) -> tuple[Problem, float]:
    """Returns (problem, rho). Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((nx, nx)) / np.sqrt(nx)
    # Pull the continuous-time generator toward stability.
    M -= 0.5 * np.eye(nx)
    A = np.eye(nx) + dt * M
    # Clamp spectral radius so random plants stay near-marginally stable.
    rad = np.max(np.abs(np.linalg.eigvals(A)))
    if rad > 1.05:
        A *= 1.05 / rad
    B = rng.standard_normal((nx, nu)) / np.sqrt(nx)

    Q = q_scale * (0.5 + rng.random(nx))
    R = r_scale * (0.5 + rng.random(nu))
    rho = 1.0

    problem = make_problem(
        A, B, Q, R, horizon, u_bound=bound, x_bound=10.0 * bound,
        dtype=dtype, device=device,
    )
    return problem, rho
