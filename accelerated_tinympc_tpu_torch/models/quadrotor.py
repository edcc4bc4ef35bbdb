"""Crazyflie-style quadrotor LTI problem family.

12 states (position, Rodrigues attitude params, linear/angular velocity), 4
motor thrust inputs, discretized at 20/50/100 Hz. The numeric data under
``data/`` is this package's own copy of the reference's problem headers
(reference: examples/problem_data/quadrotor_*hz_params.hpp,
examples/trajectory_data/*.hpp).

The setup functions reproduce the reference example setups:
- hovering: box bounds u in [-0.5, 0.5], x in [-5, 5], hover setpoint z = 2
  (reference: examples/quadrotor_hovering.cpp:44-47,83-85).
- tracking: sliding window over a full reference trajectory
  (reference: examples/quadrotor_tracking.cpp:84-101).
"""

from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

from ..types import Cache, Problem
from ._problem import make_problem

DATA_DIR = pathlib.Path(__file__).parent / "data"

NX, NU = 12, 4
HOVER_SETPOINT = np.array([0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)
HOVER_X0 = np.array([0, 1, 0, 0.2, 0, 0, 0.1, 0, 0, 0, 0, 0], np.float64)


def _load(hz: int) -> dict[str, np.ndarray]:
    return dict(np.load(DATA_DIR / f"quadrotor_{hz}hz_params.npz"))


def load_quadrotor_cache(
    hz: int = 20, dtype: Any = torch.float32, device: Any = "cuda"
) -> Cache:
    """The precomputed Riccati cache shipped with the reference data headers
    (reference: examples/problem_data/quadrotor_20hz_params.hpp:35-87)."""
    d = _load(hz)
    t = lambda k: torch.as_tensor(np.asarray(d[k], np.float64)).to(
        device=device, dtype=dtype)
    return Cache(
        rho=t("rho"), Kinf=t("Kinf"), Pinf=t("Pinf"),
        Quu_inv=t("Quu_inv"), AmBKt=t("AmBKt"), coeff_d2p=t("coeff_d2p"),
    )


def load_quadrotor_problem(
    hz: int = 20,
    horizon: int = 10,
    *,
    u_bound: float = 0.5,
    x_bound: float = 5.0,
    Xref: np.ndarray | None = None,
    dtype: Any = torch.float32,
    device: Any = "cuda",
) -> Problem:
    """Quadrotor Problem with constant box bounds and an optional reference
    window; defaults mirror examples/quadrotor_hovering.cpp:44-50."""
    d = _load(hz)
    return make_problem(
        d["Adyn"], d["Bdyn"], d["Q"], d["R"], horizon,
        u_bound=u_bound, x_bound=x_bound, Xref=Xref,
        dtype=dtype, device=device,
    )


def load_trajectory(name: str = "quadrotor_20hz_y_axis_line") -> np.ndarray:
    """Full reference trajectory as a numpy array, shape (NTOTAL, nx)
    (reference: examples/trajectory_data/*.hpp)."""
    return np.load(DATA_DIR / f"{name}.npz")["Xref"]


def quadrotor_hovering_setup(
    hz: int = 20, horizon: int = 10, dtype: Any = torch.float32,
    device: Any = "cuda",
) -> tuple[Problem, Cache, np.ndarray]:
    """(problem, cache, x0) for the hovering example: hover setpoint z=2
    replicated over the horizon, canonical initial state (a numpy vector)
    (reference: examples/quadrotor_hovering.cpp:83-88)."""
    Xref = np.tile(HOVER_SETPOINT, (horizon, 1))
    problem = load_quadrotor_problem(
        hz, horizon, Xref=Xref, dtype=dtype, device=device)
    cache = load_quadrotor_cache(hz, dtype, device)
    return problem, cache, HOVER_X0.copy()


def quadrotor_tracking_setup(
    hz: int = 20,
    horizon: int = 10,
    trajectory: str = "quadrotor_20hz_y_axis_line",
    dtype: Any = torch.float32,
    device: Any = "cuda",
) -> tuple[Problem, Cache, np.ndarray, np.ndarray]:
    """(problem, cache, x0, Xref_total) for the tracking example; the caller
    slides ``problem.Xref`` over ``Xref_total`` each tick
    (reference: examples/quadrotor_tracking.cpp:84-101)."""
    Xref_total = load_trajectory(trajectory)
    problem = load_quadrotor_problem(
        hz, horizon, Xref=Xref_total[:horizon], dtype=dtype, device=device)
    cache = load_quadrotor_cache(hz, dtype, device)
    x0 = Xref_total[0].copy()
    return problem, cache, x0, Xref_total
