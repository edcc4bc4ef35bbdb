"""Upright cartpole LTI problem (4 states: cart position, pole angle, and
their rates; 1 force input).

Plant/cost numbers match the reference codegen example (reference:
examples/codegen_cartpole.cpp:17-28 -- the reference arrays are column-major;
they are transposed into row-major here).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..types import Problem
from ._problem import make_problem

NX, NU = 4, 1

# reference examples/codegen_cartpole.cpp:22-23 (col-major flat data): each
# inner list below is one *column* of A; the transpose restores row-major A.
A = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.01, 1.0, 0.0, 0.0],
     [2.2330083403300767e-5, 0.004466210576510177, 1.0002605176397052,
      0.05210579005928538],
     [7.443037974683548e-8, 2.2330083403300767e-5, 0.01000086835443038,
      1.0002605176397052]],
    dtype=np.float64,
).T
B = np.array(
    [[7.468368562730335e-5, 0.014936765390161838, 3.79763323185387e-5,
      0.007595596218554721]],
    dtype=np.float64,
).T  # (nx, nu)
Q_DIAG = np.array([10.0, 1.0, 10.0, 1.0])
R_DIAG = np.array([1.0])
RHO = 0.1


def cartpole_problem(
    horizon: int = 10,
    *,
    x_bound: float = 5.0,
    u_bound: float = 5.0,
    dtype: Any = torch.float32,
    device: Any = "cuda",
) -> Problem:
    """Cartpole Problem with the reference's +-5 box bounds
    (reference: examples/codegen_cartpole.cpp:50-60)."""
    return make_problem(
        A, B, Q_DIAG, R_DIAG, horizon,
        u_bound=u_bound, x_bound=x_bound, dtype=dtype, device=device,
    )
