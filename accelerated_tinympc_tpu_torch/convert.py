"""State carried across from the JAX package: numpy in, the port's
dataclasses out (and back).

Every function takes a dict of numpy arrays keyed by the field names of the
JAX package's dataclass of the same name (``Problem``, ``Cache``, ``State``,
``FusedCarry``, ``FusedResult``), plus ``device=``/``dtype=``. A caller that
holds JAX objects builds the dicts itself (``np.asarray`` of each field);
this module imports no JAX.

The JAX fused tier keeps its carries and results padded to 128 lanes
(``Du -> 128``, ``Dx -> 128``-multiples, stats ``(B, 128)`` with 6 lanes
used). The port's layout is unpadded, so the converters strip the padding
(asserting it is zero) on the way in and restore it on the way out.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ops.fused_admm import FusedCarry, FusedResult
from .types import DEFAULT_DEVICE, Cache, Problem, Settings, State

LANES = 128  # lane width the JAX fused tier pads to

_CACHE = ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "coeff_d2p")
_PROBLEM = ("A", "B", "Q", "R", "u_min", "u_max", "x_min", "x_max",
            "Xref", "Uref")
_STATE_F = ("x", "u", "q", "r", "p", "d", "v", "vnew", "z", "znew", "g", "y",
            "primal_residual_state", "primal_residual_input",
            "dual_residual_state", "dual_residual_input")
_STATE_I = ("status", "iter")
_SETTINGS = ("abs_pri_tol", "abs_dua_tol", "max_iter", "check_termination",
             "en_state_bound", "en_input_bound", "alpha")


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def problem_from_numpy(fields: Mapping[str, Any], *,
                       dtype: Any = torch.float32,
                       device: Any = DEFAULT_DEVICE) -> Problem:
    return Problem(**{k: _t(fields[k], dtype, device) for k in _PROBLEM})


def cache_from_numpy(fields: Mapping[str, Any], *,
                     dtype: Any = torch.float32,
                     device: Any = DEFAULT_DEVICE) -> Cache:
    return Cache(**{k: _t(fields[k], dtype, device) for k in _CACHE})


def settings_from(fields: Mapping[str, Any]) -> Settings:
    """Settings from a mapping of the JAX ``Settings`` fields (tolerances may
    be 0-d arrays there; here they are Python floats)."""
    kw = {k: fields[k] for k in _SETTINGS if k in fields}
    for k in ("abs_pri_tol", "abs_dua_tol", "alpha"):
        if k in kw:
            kw[k] = float(np.asarray(kw[k]))
    for k in ("max_iter", "check_termination"):
        if k in kw:
            kw[k] = int(kw[k])
    return Settings(**kw)


def state_from_numpy(fields: Mapping[str, Any], *,
                     dtype: Any = torch.float32,
                     device: Any = DEFAULT_DEVICE) -> State:
    out = {k: _t(fields[k], dtype, device) for k in _STATE_F}
    out.update({k: _t(fields[k], torch.int32, device) for k in _STATE_I})
    return State(**out)


def state_to_numpy(state: State) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.tensors().items()}


def _strip(a, width: int, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.shape[-1] < width:
        raise ValueError(f"{name} has {a.shape[-1]} lanes, needs {width}")
    if a.shape[-1] > width and np.any(a[..., width:] != 0):
        raise ValueError(f"{name}: padding lanes beyond {width} are not zero")
    return a[..., :width]


def _pad(a: torch.Tensor, lanes: int = LANES) -> np.ndarray:
    a = a.detach().cpu().numpy()
    width = -(-a.shape[-1] // lanes) * lanes
    out = np.zeros(a.shape[:-1] + (width,), a.dtype)
    out[..., : a.shape[-1]] = a
    return out


def fused_carry_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                           dtype: Any = torch.float32,
                           device: Any = DEFAULT_DEVICE) -> FusedCarry:
    """``FusedCarry`` from the JAX carry's fields ``D, Y, G, Z, V`` (padded
    ``(B, 128k)``) for a problem of ``dims = (nx, nu, horizon)``: strips the
    lane padding and asserts the stripped lanes are zero."""
    nx, nu, N = dims
    Du, Dx = (N - 1) * nu, N * nx
    w = {"D": Du, "Y": Du, "Z": Du, "G": Dx, "V": Dx}
    return FusedCarry(**{
        k: _t(_strip(fields[k], w[k], f"carry.{k}"), dtype, device)
        for k in ("D", "Y", "G", "Z", "V")
    })


def fused_result_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                            dtype: Any = torch.float32,
                            device: Any = DEFAULT_DEVICE) -> FusedResult:
    """``FusedResult`` from the JAX result's ``U, X, carry, stats`` (``carry``
    itself a mapping): padding stripped, stats ``(B, 128) -> (B, 6)``."""
    nx, nu, N = dims
    return FusedResult(
        U=_t(_strip(fields["U"], (N - 1) * nu, "U"), dtype, device),
        X=_t(_strip(fields["X"], N * nx, "X"), dtype, device),
        carry=fused_carry_from_numpy(
            fields["carry"], dims, dtype=dtype, device=device),
        stats=_t(_strip(fields["stats"], 6, "stats"), dtype, device),
    )


def fused_result_to_numpy(res: FusedResult) -> dict[str, Any]:
    """The JAX layout of a ``FusedResult``: every array padded with zero
    lanes to a multiple of 128, stats ``(B, 6) -> (B, 128)``."""
    return {
        "U": _pad(res.U), "X": _pad(res.X),
        "carry": {k: _pad(getattr(res.carry, k))
                  for k in ("D", "Y", "G", "Z", "V")},
        "stats": _pad(res.stats),
    }
