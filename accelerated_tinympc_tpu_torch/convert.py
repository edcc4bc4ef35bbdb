"""State carried across from the JAX package: numpy in, the port's
dataclasses out (and back).

Every function takes a dict of numpy arrays keyed by the field names of the
JAX package's dataclass of the same name (``Problem``, ``Cache``, ``State``,
``FusedCarry``, ``FusedResult``, ``InstanceOps``, ``HeteroCarry``,
``HeteroResult``, ``StreamCarry``, ``StreamProblem``, ``HStreamProblem``),
plus
``device=``/``dtype=``. A batch-leading ``Cache`` goes through
:func:`cache_from_numpy` unchanged (every field keeps its leading axis). A caller that
holds JAX objects builds the dicts itself (``np.asarray`` of each field);
this module imports no JAX.

Cones: :func:`cone_set_from` rebuilds a ``ConeSet`` from the JAX one's plain
values. The JAX ``FusedConeOps`` is *not* converted: it holds gather/scatter
matrices and mask rows laid out for the TPU's lanes, while the port's holds
indices; rebuild it with the port's ``pad_cones`` from the converted
``ConeSet``.

The JAX fused tier keeps its carries and results padded to 128 lanes
(``Du -> 128``, ``Dx -> 128``-multiples, stats ``(B, 128)`` with 6 lanes
used). The port's layout is unpadded, so the converters strip the padding
(asserting it is zero) on the way in and restore it on the way out.

The JAX hetero tier packs its carry with instances on the 128 lanes of a
tile and each knot's rows padded to a multiple of 8
(``(NT * knots * S, 128)``); :func:`hetero_carry_from_numpy` unpacks it into
the port's batch-leading :class:`..ops.hetero_admm.HeteroCarry` (padding
checked to be zero), so a JAX warm carry can be carried across.

The JAX stream and hstream tiers keep their carry as ``(NT, N, S, 128)``
(instances on the lanes of a tile, rows padded to a multiple of 8, the
input-width arrays with a zero terminal knot); :func:`stream_carry_from_numpy`
and :func:`stream_carry_to_numpy` convert it to and from the port's
batch-leading :class:`..ops.stream_admm.StreamCarry`.
:func:`stream_problem_from_numpy` and :func:`hstream_problem_from_numpy`
unpack the two tiers' padded and lane-packed operands, so a warm JAX carry
and the same operands give the same solve in both packages.
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


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _unpack_lanes(p, knots: int, width: int, batch, name: str) -> np.ndarray:
    """``(NT * knots * S, 128)`` lane-packed rows (S = width padded to a
    multiple of 8) -> ``(batch, knots, width)``; padding rows and padding
    instances must be zero."""
    p = np.asarray(p)
    S = _pad8(width)
    rows = knots * S
    if p.ndim != 2 or p.shape[1] != LANES or p.shape[0] % rows:
        raise ValueError(f"{name}: expected (NT*{rows}, {LANES}), got "
                         f"{p.shape}")
    nt = p.shape[0] // rows
    a = p.reshape(nt, rows, LANES).transpose(0, 2, 1).reshape(
        nt * LANES, knots, S)
    a = _strip(a, width, name)
    if batch is not None:
        if batch > a.shape[0]:
            raise ValueError(f"{name}: {a.shape[0]} lanes, batch {batch}")
        if np.any(a[batch:] != 0):
            raise ValueError(f"{name}: lanes beyond batch {batch} are not "
                             "zero")
        a = a[:batch]
    return a


def hetero_carry_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                            batch: int | None = None,
                            dtype: Any = torch.float32,
                            device: Any = DEFAULT_DEVICE):
    """The port's ``HeteroCarry`` from the JAX one's lane-packed fields
    ``d, y, z ((NT*(N-1)*SU, 128))`` and ``g, v ((NT*N*SX, 128))`` for
    ``dims = (nx, nu, horizon)``. ``batch`` drops the padding instances of
    the last tile (checked to be zero); without it every lane is kept."""
    from .ops.hetero_admm import HeteroCarry

    nx, nu, N = dims
    shape = {"d": (N - 1, nu), "y": (N - 1, nu), "z": (N - 1, nu),
             "g": (N, nx), "v": (N, nx)}
    return HeteroCarry(**{
        k: _t(_unpack_lanes(fields[k], *shape[k], batch, f"carry.{k}"),
              dtype, device)
        for k in ("d", "y", "g", "z", "v")})


def hetero_result_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                             dtype: Any = torch.float32,
                             device: Any = DEFAULT_DEVICE):
    """The port's ``HeteroResult`` from the JAX one's ``U (B, N-1, nu)``,
    ``X (B, N, nx)``, ``stats (B, 8)`` (already batch-leading there) and
    lane-packed ``carry`` (a mapping of its fields)."""
    from .ops.hetero_admm import HeteroResult

    U = np.asarray(fields["U"])
    return HeteroResult(
        carry=hetero_carry_from_numpy(fields["carry"], dims,
                                      batch=U.shape[0], dtype=dtype,
                                      device=device),
        U=_t(U, dtype, device), X=_t(fields["X"], dtype, device),
        stats=_t(fields["stats"], dtype, device))


def cone_set_from(cones):
    """The port's ``ConeSet`` from the JAX package's (or any object with
    ``input_cones``/``state_cones`` of ``(ball, axis, mu, shift)`` tuples)."""
    from .solver.cones import Cone, ConeSet

    conv = lambda group: tuple(
        Cone(tuple(int(b) for b in c[0]), int(c[1]), float(c[2]),
             float(c[3]) if len(c) > 3 else 0.0) for c in group)
    return ConeSet(input_cones=conv(cones.input_cones),
                   state_cones=conv(cones.state_cones))


def instance_ops_from_numpy(fields: Mapping[str, Any], *,
                            dtype: Any = torch.float32,
                            device: Any = DEFAULT_DEVICE):
    """``InstanceOps`` (batch-leading per-instance operators) from the JAX
    one's fields; the layouts are the same."""
    from .solver.batched_ops import InstanceOps

    return InstanceOps(**{k: _t(fields[k], dtype, device)
                          for k in InstanceOps._fields})


# ------------------------------------------------------- stream and hstream --

def _unpack_tiles(p, knots: int, width: int, batch, name: str) -> np.ndarray:
    """``(NT, N, S, 128)`` -> ``(batch, knots, width)``; padding rows, knots
    past ``knots`` and instances past ``batch`` must be zero."""
    p = np.asarray(p)
    if p.ndim != 4 or p.shape[3] != LANES or p.shape[2] != _pad8(width):
        raise ValueError(f"{name}: expected (NT, N, {_pad8(width)}, {LANES}),"
                         f" got {p.shape}")
    nt, N = p.shape[:2]
    a = _strip(p.transpose(0, 3, 1, 2).reshape(nt * LANES, N, p.shape[2]),
               width, name)
    if np.any(a[:, knots:] != 0):
        raise ValueError(f"{name}: knots past {knots} are not zero")
    a = a[:, :knots]
    if batch is not None:
        if np.any(a[batch:] != 0):
            raise ValueError(f"{name}: lanes beyond batch {batch} are not "
                             "zero")
        a = a[:batch]
    return a


def _pack_tiles(a: np.ndarray, N: int) -> np.ndarray:
    """``(B, knots, width)`` -> ``(NT, N, S, 128)``, zero-padded."""
    Bn, knots, width = a.shape
    nt = -(-Bn // LANES)
    out = np.zeros((nt * LANES, N, _pad8(width)), a.dtype)
    out[:Bn, :knots, :width] = a
    return out.reshape(nt, LANES, N, _pad8(width)).transpose(0, 2, 3, 1)


def stream_carry_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                            batch: int | None = None,
                            dtype: Any = torch.float32,
                            device: Any = DEFAULT_DEVICE):
    """The port's ``StreamCarry`` from the JAX one's packed fields ``d, y, z
    (NT, N, SU, 128)`` and ``g, v (NT, N, SX, 128)`` for ``dims = (nx, nu,
    horizon)``; ``batch`` drops the padding instances (checked zero)."""
    from .ops.stream_admm import StreamCarry

    nx, nu, N = dims
    shape = {"d": (N - 1, nu), "y": (N - 1, nu), "z": (N - 1, nu),
             "g": (N, nx), "v": (N, nx)}
    return StreamCarry(**{
        k: _t(_unpack_tiles(fields[k], *shape[k], batch, f"carry.{k}"),
              dtype, device) for k in StreamCarry._fields})


def stream_carry_to_numpy(carry) -> dict[str, np.ndarray]:
    """The JAX ``StreamCarry`` fields (packed ``(NT, N, S, 128)``) of a port
    ``StreamCarry``."""
    N = carry.g.shape[1]
    return {k: _pack_tiles(getattr(carry, k).detach().cpu().numpy(), N)
            for k in carry._fields}


def _lane_col(p, width: int, name: str) -> np.ndarray:
    """The per-lane-uniform rows of a JAX ``(S, 128)`` (or ``(N, S, 128)``)
    operand: lane 0, padding rows stripped."""
    p = np.asarray(p)
    if np.any(p != p[..., :1]):
        raise ValueError(f"{name}: lanes differ, expected a shared operand")
    return _strip(p[..., 0], width, name)


def stream_problem_from_numpy(fields: Mapping[str, Any], dims: tuple, *,
                              dtype: Any = torch.float32,
                              device: Any = DEFAULT_DEVICE):
    """The port's ``StreamProblem`` from the JAX one's fields (sublane-padded
    matrices, bounds and ``qc``/``pterm`` broadcast over 128 lanes, optional
    per-knot schedules ``u_min_k ... (N, S, 128)``)."""
    from .ops.stream_admm import StreamProblem

    nx, nu, N = dims
    mat = lambda k, r, c: _t(np.asarray(fields[k])[:r, :c], dtype, device)
    knot = fields.get("u_min_k") is not None
    bounds = {}
    for name, width, knots in (("u_min", nu, N - 1), ("u_max", nu, N - 1),
                               ("x_min", nx, N), ("x_max", nx, N)):
        rows = (_lane_col(fields[name + "_k"], width, name)[:knots] if knot
                else _lane_col(fields[name], width, name)[None])
        bounds[name] = _t(rows, dtype, device)
    return StreamProblem(
        A=mat("A", nx, nx), B=mat("B", nx, nu), Kinf=mat("Kinf", nu, nx),
        Quu_inv=mat("Quu_inv", nu, nu), AmBKt=mat("AmBKt", nx, nx),
        qc=_t(_lane_col(fields["qc"], nx, "qc"), dtype, device),
        pterm=_t(_lane_col(fields["pterm"], nx, "pterm"), dtype, device),
        rho=_t(np.asarray(fields["rho"]).reshape(()), dtype, device),
        dims=(nx, nu, N), **bounds)


def hstream_problem_from_numpy(fields: Mapping[str, Any], dims: tuple,
                               batch: int, *, dtype: Any = torch.float32,
                               device: Any = DEFAULT_DEVICE):
    """The port's ``HStreamProblem`` from the JAX one's lane-packed fields:
    matrices in the transposed-3D ``(NT*R_in, R_out, 128)`` packing, rows
    ``(NT*S, 128)``, ``qc`` and per-knot bounds ``(NT, N, S, 128)``."""
    from .ops.hstream_admm import HStreamProblem

    nx, nu, N = dims

    def mat(k, r_out, r_in):  # -> (B, r_out, r_in)
        p = np.asarray(fields[k])
        R_in, R_out = _pad8(r_in), p.shape[1]
        nt = p.shape[0] // R_in
        a = p.reshape(nt, R_in, R_out, LANES).transpose(0, 3, 1, 2).reshape(
            nt * LANES, R_in, R_out)[:batch, :r_in, :r_out]
        return _t(a.transpose(0, 2, 1), dtype, device)

    def rows(k, width):  # (NT*S, 128) -> (B, width)
        p = np.asarray(fields[k])
        S = _pad8(width)
        nt = p.shape[0] // S
        a = p.reshape(nt, S, LANES).transpose(0, 2, 1).reshape(nt * LANES, S)
        return a[:batch, :width]

    knot = fields.get("u_min_k") is not None
    bounds = {}
    for name, width, knots in (("u_min", nu, N - 1), ("u_max", nu, N - 1),
                               ("x_min", nx, N), ("x_max", nx, N)):
        b = (_unpack_tiles(fields[name + "_k"], N, width, None, name)
             [:batch, :knots] if knot else rows(name, width)[:, None])
        bounds[name] = _t(b, dtype, device)
    return HStreamProblem(
        A=mat("A3", nx, nx), B=mat("B3", nx, nu), Kinf=mat("K3", nu, nx),
        Quu_inv=mat("Quu3", nu, nu), AmBKt=mat("M3", nx, nx),
        qc=_t(_unpack_tiles(fields["qc"], N, nx, None, "qc")[:batch],
              dtype, device),
        pterm=_t(rows("pterm", nx), dtype, device),
        rho=_t(rows("rho_x", nx)[:, 0], dtype, device),
        dims=(nx, nu, N), **bounds)
