"""Core data model: frozen dataclasses of tensors for problem, cache,
settings and solver state.

Semantic counterpart of the reference's mutable global workspace (reference:
src/tinympc/types.hpp:26-107 -- TinyCache/TinySettings/TinyWorkspace), and
field for field the counterpart of the JAX package's ``types.py``:

- Arrays are **time-major** ``(N, nx)`` / ``(N-1, nu)``; a batch axis is
  written out as the leading axis.
- State is immutable; every ADMM stage is a function ``state -> state`` that
  builds a new dataclass with :meth:`replace`.
- Iteration limits, bound-enable flags and ``alpha`` live in
  :class:`Settings` as plain Python values.

Every dataclass has ``replace(**fields)`` and ``to(device=..., dtype=...)``.
Functions that create tensors take ``device=`` and default to ``"cuda"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

Tensor = torch.Tensor

# Solver status codes (reference: src/tinympc/admm.cpp:114,136 -- 11 =
# TINY_UNSOLVED, 1 = TINY_SOLVED; a max-iter exit leaves status at 11).
UNSOLVED = 11
SOLVED = 1

DEFAULT_DEVICE = "cuda"


class _Struct:
    """``replace``/``to`` for the frozen dataclasses below."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device=None, dtype=None):
        """Move every tensor field; ``dtype`` applies to floating fields only
        (status/iteration counters keep their integer type)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.to(
                    device=device,
                    dtype=dtype if v.is_floating_point() else None,
                )
            out[f.name] = v
        return type(self)(**out)

    def tensors(self) -> dict[str, Tensor]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }


@dataclasses.dataclass(frozen=True)
class Cache(_Struct):
    """Precomputed infinite-horizon Riccati cache (reference:
    src/tinympc/types.hpp:26-34). Shapes: ``Kinf (nu, nx)``, ``Pinf (nx,
    nx)``, ``Quu_inv (nu, nu)``, ``AmBKt (nx, nx)``, ``coeff_d2p (nx, nu)``;
    ``rho`` scalar tensor."""

    rho: Tensor
    Kinf: Tensor
    Pinf: Tensor
    Quu_inv: Tensor
    AmBKt: Tensor
    coeff_d2p: Tensor

    @property
    def nx(self) -> int:
        return self.Pinf.shape[-1]

    @property
    def nu(self) -> int:
        return self.Quu_inv.shape[-1]


@dataclasses.dataclass(frozen=True)
class Settings(_Struct):
    """Solver settings (reference: src/tinympc/types.hpp:39-47).

    ``check_termination == 0`` disables the termination check entirely
    (fixed-iteration mode, used for deterministic benchmarking and
    golden-parity runs). ``alpha`` is OSQP-style over-relaxation (beyond the
    reference, off by default: 1.0 reproduces the reference schedule). With
    ``alpha != 1`` the slack/dual stages see the relaxed iterate
    ``alpha * u + (1 - alpha) * z_old`` (likewise for states).
    """

    abs_pri_tol: float = 1e-3
    abs_dua_tol: float = 1e-3
    max_iter: int = 100
    check_termination: int = 1
    en_state_bound: bool = True
    en_input_bound: bool = True
    alpha: float = 1.0


@dataclasses.dataclass(frozen=True)
class Problem(_Struct):
    """Time-invariant problem data + references + bounds (reference:
    src/tinympc/types.hpp:83-93). ``Q``/``R`` are the diagonal cost vectors
    exactly as the user supplies them (raw in the examples, rho-augmented in
    codegen output); whichever the caller provides is reproduced, never
    "fixed".

    Shapes (single instance): ``A (nx, nx)``, ``B (nx, nu)``, ``Q (nx,)``,
    ``R (nu,)``, ``x_min/x_max/Xref (N, nx)``, ``u_min/u_max/Uref (N-1, nu)``.
    """

    A: Tensor
    B: Tensor
    Q: Tensor
    R: Tensor
    u_min: Tensor
    u_max: Tensor
    x_min: Tensor
    x_max: Tensor
    Xref: Tensor
    Uref: Tensor

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    @property
    def horizon(self) -> int:
        return self.Xref.shape[-2]


@dataclasses.dataclass(frozen=True)
class State(_Struct):
    """ADMM iterates + diagnostics: the mutable half of TinyWorkspace
    (reference: src/tinympc/types.hpp:52-81), carried functionally.

    Shapes (single instance): ``x/q/p/v/vnew/g (N, nx)``;
    ``u/r/d/z/znew/y (N-1, nu)``. Warm starting across MPC ticks is
    expressed by reusing the returned State for the next solve (the
    reference resets only y and g between ticks --
    examples/quadrotor_hovering.cpp:99-104).
    """

    x: Tensor
    u: Tensor
    q: Tensor
    r: Tensor
    p: Tensor
    d: Tensor
    v: Tensor
    vnew: Tensor
    z: Tensor
    znew: Tensor
    g: Tensor
    y: Tensor
    primal_residual_state: Tensor
    primal_residual_input: Tensor
    dual_residual_state: Tensor
    dual_residual_input: Tensor
    status: Tensor
    iter: Tensor


def init_state(
    nx: int, nu: int, horizon: int, dtype: Any = torch.float32,
    device: Any = DEFAULT_DEVICE,
) -> State:
    """Cold-start state: everything zeroed (reference:
    examples/quadrotor_hovering.cpp:52-71)."""
    xs = torch.zeros((horizon, nx), dtype=dtype, device=device)
    us = torch.zeros((horizon - 1, nu), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    izero = torch.zeros((), dtype=torch.int32, device=device)
    return State(
        x=xs, u=us, q=xs, r=us, p=xs, d=us,
        v=xs, vnew=xs, z=us, znew=us, g=xs, y=us,
        primal_residual_state=zero, primal_residual_input=zero,
        dual_residual_state=zero, dual_residual_input=zero,
        status=izero, iter=izero,
    )


def reset_duals(state: State) -> State:
    """Zero the dual variables y, g between MPC ticks (reference:
    examples/quadrotor_hovering.cpp:100-101)."""
    return state.replace(
        y=torch.zeros_like(state.y), g=torch.zeros_like(state.g)
    )


def set_x0(state: State, x0: Tensor) -> State:
    """Install the measured state into the first knot (reference:
    examples/quadrotor_hovering.cpp:95). Works with any leading batch axes."""
    x = state.x.clone()
    x[..., 0, :] = torch.as_tensor(x0, dtype=x.dtype, device=x.device)
    return state.replace(x=x)
