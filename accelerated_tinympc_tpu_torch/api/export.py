"""AOT export: freeze a solve into a serialized artifact with
``torch.export``.

The deployment half of the reference's codegen capability (reference:
src/tinympc/codegen.cpp -- freeze solver + data so the solve can run
elsewhere without the setup toolchain). Counterpart of the JAX package's
``api/export.py``, with the same entry points, signatures and named outputs:

- :func:`export_batched_solve`: the scan tier's batched solve, ``x0s (batch,
  nx) -> dict``, problem and cache baked in. The iteration loop is one
  ``while_loop`` (traced once whatever ``max_iter``); with
  ``check_termination > 0`` it stops when every instance has converged and
  freezes converged instances on the way, as the live
  :func:`..solver.batched.solve_batched` does, so the artifact gives its
  bits.
- :func:`export_fused_solve`: the fused CUDA tier (K1 fixed, K2 adaptive)
  through the ``atm_torch::fused_solve`` op
  (:mod:`..ops.fused_admm`), operators baked in: on the card the artifact
  launches the same kernel as :func:`..ops.fused_admm.fused_solve`, on the
  CPU it runs the plain version.

Divergence from ``jax.export``: a JAX artifact is self-contained StableHLO.
A ``torch.export`` artifact of the fused solve names the custom op, whose
implementation lives in this package: :func:`load_exported` imports
:mod:`..ops.fused_admm` first so that the op is registered. An artifact
holds its constants on one device (the problem's, or ``platforms[0]``).
"""

from __future__ import annotations

import pathlib
from typing import Any, Callable

import torch

from ..solver.admm import _select, admm_iteration
from ..solver.batched import init_state_batched
from ..types import SOLVED, UNSOLVED, Cache, Problem, Settings, State

_STATE_FIELDS = tuple(State.__dataclass_fields__)


def _device(platforms, default) -> torch.device:
    if platforms is None:
        return torch.device(default)
    platforms = tuple(platforms)
    if len(platforms) != 1:
        raise ValueError(
            "a torch.export artifact holds its constants on one device: pass "
            f"one platform ('cpu' or 'cuda'), got {platforms!r}")
    return torch.device(platforms[0])


def _export(module: torch.nn.Module, args: tuple):
    with torch.no_grad():
        return torch.export.export(module, args, strict=False)


def _solve_loop(state: State, problem: Problem, cache: Cache,
                settings: Settings, project) -> State:
    """:func:`..solver.batched.solve_batched`'s loop as one ``while_loop``:
    fixed ``max_iter`` iterations, or (adaptive) until every instance is
    solved, converged instances frozen by the same select.

    The loop is the ``while_loop`` operator itself, traced into the artifact
    by ``torch.export`` (the public ``while_loop`` would trace its body with
    dynamo first, several times slower); problem and cache enter it as its
    additional inputs, so its body closes over no tensor."""
    from torch._higher_order_ops.while_loop import while_loop_op

    adaptive = settings.check_termination > 0
    n = len(_STATE_FIELDS)
    p_keys, c_keys = tuple(problem.tensors()), tuple(cache.tensors())

    def cond(i, *args):
        go = i < settings.max_iter
        if adaptive:
            go = go & ~(args[_STATE_FIELDS.index("status")] == SOLVED).all()
        return go

    def body(i, *args):
        s = State(**dict(zip(_STATE_FIELDS, args[:n])))
        p = problem.replace(**dict(zip(p_keys, args[n:n + len(p_keys)])))
        c = cache.replace(**dict(zip(c_keys, args[n + len(p_keys):])))
        new = admm_iteration(s, p, c, settings, project=project)
        if adaptive:
            new = _select(s.status == SOLVED, s, new)
        # A loop body may not return its inputs or one tensor twice.
        return (i + 1,) + tuple(getattr(new, k).clone() for k in _STATE_FIELDS)

    i0 = torch.zeros((), dtype=torch.int64, device=state.x.device)
    carried = (i0,) + tuple(getattr(state, k) for k in _STATE_FIELDS)
    baked = (tuple(problem.tensors().values())
             + tuple(cache.tensors().values()))
    out = while_loop_op(cond, body, carried, baked)
    return State(**dict(zip(_STATE_FIELDS, out[1:])))


class _BatchedSolve(torch.nn.Module):
    def __init__(self, problem, cache, settings, batch, project):
        super().__init__()
        self.problem, self.cache, self.settings = problem, cache, settings
        self.batch, self.project = batch, project

    def forward(self, x0s: torch.Tensor) -> dict[str, torch.Tensor]:
        p = self.problem
        nx, nu, N = p.nx, p.nu, p.horizon
        state = init_state_batched(self.batch, nx, nu, N, x0s.dtype,
                                   x0s.device)
        x = state.x.clone()
        x[:, 0, :] = x0s
        state = state.replace(
            x=x, status=torch.full_like(state.status, UNSOLVED),
            iter=torch.zeros_like(state.iter))
        out = _solve_loop(state, p, self.cache, self.settings, self.project)
        return {
            "x": out.x, "u": out.u,
            "iterations": out.iter, "status": out.status,
            "primal_residual_state": out.primal_residual_state,
            "primal_residual_input": out.primal_residual_input,
            "dual_residual_state": out.dual_residual_state,
            "dual_residual_input": out.dual_residual_input,
        }


def export_batched_solve(
    problem: Problem,
    cache: Cache,
    settings: Settings,
    batch: int,
    *,
    platforms: tuple[str, ...] | None = None,
    cones=None,
) -> torch.export.ExportedProgram:
    """Export ``x0s (batch, nx) float32 -> dict`` of the solved ``x``,
    ``u``, ``iterations``, ``status`` and the four residuals, with problem
    and cache baked in (on ``platforms[0]``, default the problem's device).
    ``cones`` (a :class:`..solver.cones.ConeSet`) bakes SOC projections into
    the artifact."""
    dev = _device(platforms, problem.A.device)
    problem, cache = problem.to(device=dev), cache.to(device=dev)
    project = None
    if cones is not None:
        from ..solver.cones import cone_slack_update

        project = cone_slack_update(cones)
    module = _BatchedSolve(problem, cache, settings, int(batch), project)
    x0s = torch.zeros((int(batch), problem.nx), dtype=torch.float32,
                      device=dev)
    return _export(module, (x0s,))


def save_exported(path: str | pathlib.Path,
                  exported: torch.export.ExportedProgram) -> None:
    torch.export.save(exported, str(path))


def load_exported(path: str | pathlib.Path) -> Callable[..., Any]:
    """Load a saved artifact; returns a callable running the baked solve.
    Imports this package's fused-solve op first (an artifact of
    :func:`export_fused_solve` names it)."""
    from ..ops import fused_admm  # noqa: F401  (registers atm_torch::fused_solve)

    return torch.export.load(str(path)).module()


class _FusedSolve(torch.nn.Module):
    def __init__(self, pp, const_d, kw):
        super().__init__()
        for name in ("W_f", "W_b", "W_x", "lo", "hi"):
            self.register_buffer(name, getattr(pp, name))
        self.register_buffer("const_d", const_d)
        self.dims, self.rho = list(pp.dims), float(pp.rho_f)
        self.kw = kw

    def forward(self, x0, D, Y, G, Z, V) -> dict[str, torch.Tensor]:
        kw = self.kw
        U, X, D, Y, G, Z, V, stats = torch.ops.atm_torch.fused_solve(
            x0, D, Y, G, Z, V, self.W_f, self.W_b, self.W_x, self.const_d,
            self.lo, self.hi, self.dims, self.rho, kw["max_iter"],
            kw["check_termination"], 0, kw["abs_pri_tol"],
            kw["abs_dua_tol"], 1.0, kw["batch_tile"])
        return {"U": U, "X": X, "stats": stats,
                "D": D, "Y": Y, "G": G, "Z": Z, "V": V}


def export_fused_solve(
    pp,
    batch: int,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int | None = None,
    platforms: tuple[str, ...] | None = None,
) -> torch.export.ExportedProgram:
    """Export the fused whole-solve (K1 fixed, K2 with ``check_termination >
    0``; operators baked in) as an artifact -- the deployment form of the
    fastest path.

    Signature of the exported callable: ``(x0 (B, nx), D, Y, G, Z, V) ->
    dict`` with the solved ``U``/``X``, the updated carries and ``stats``
    (:class:`..ops.fused_admm.FusedResult`'s layout: carries unpadded,
    ``(B, Du)`` and ``(B, Dx)``; the JAX package's are padded to 128
    lanes). ``batch_tile`` fixes the slots per block (default: the launch's
    own choice)."""
    from ..ops.fused_admm import fold_const_d

    if max_iter < 1:
        raise ValueError("the fused tier runs at least one iteration; "
                         "use the scan tier for max_iter=0")
    dev = _device(platforms, pp.W_f.device)
    pp = pp.to(device=dev)
    with torch.no_grad():
        const_d = fold_const_d(pp)
    kw = dict(max_iter=int(max_iter), check_termination=int(check_termination),
              abs_pri_tol=float(abs_pri_tol), abs_dua_tol=float(abs_dua_tol),
              batch_tile=-1 if batch_tile is None else int(batch_tile))
    module = _FusedSolve(pp, const_d, kw)
    f32 = lambda w: torch.zeros((int(batch), w), dtype=torch.float32,
                                device=dev)
    nx = pp.dims[0]
    args = (f32(nx), f32(pp.Du), f32(pp.Du), f32(pp.Dx), f32(pp.Du),
            f32(pp.Dx))
    return _export(module, args)
