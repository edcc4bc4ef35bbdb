"""Long-horizon fused solve with a distinct plant per instance.

Counterpart of the JAX package's ``ops/hstream_admm.py``: the hetero tier
(:mod:`.hetero_admm`) holds every knot on chip and stops at short horizons;
the stream tier (:mod:`.stream_admm`) streams long horizons for one shared
plant. Fleets of *distinct* plants over long horizons take this tier: each
instance's plant and cache (A, B, Kinf, Quu_inv, AmBKt: ~2 KB at nx=12,
nu=4) stay in registers while its iterates stream knot by knot through
device memory, both horizon recurrences of every ADMM iteration (reference:
src/tinympc/admm.cpp:27-37 forward rollout, :15-22 backward gradient
recursion) fused with the slack projection (:45-61), dual ascent (:67-71)
and linear-cost refresh (:77-85), with per-instance rho.

**Layout.** Batch-leading and unpadded, the hetero tier's operands
(:class:`HStreamProblem` has :class:`.hetero_admm.HeteroProblem`'s fields)
with the stream tier's carry (:class:`.stream_admm.StreamCarry`). Bounds
are per instance, one row ``(B, 1, k)`` (time-uniform) or a row per knot
``(B, knots, k)``. Per-instance cone parameters and geometry take the hetero
tier's operands (:func:`.hetero_admm.pad_hetero_cone_params` /
``pad_hetero_cone_masks``). The JAX package's lane packing, the
``KB_SUBLANE_CAP`` on its knot block and the cap on the adaptive knot block
(there for an artefact of the Pallas interpreter) are not carried over.

:func:`hstream_solve` launches ``csrc/stream_admm.cu`` (kernels K11 fixed,
K12 adaptive) for tensors on a CUDA device and takes
:func:`hstream_solve_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..types import Cache, Problem, _Struct
from . import hetero_admm as ha
from .stream_admm import (
    StreamCarry,
    StreamResult,
    _check_common,
    _plain,
    _rows,
    _launch,
)


@dataclasses.dataclass(frozen=True)
class HStreamProblem(_Struct):
    """Per-instance operands of the hstream tier, batch-leading.
    ``qc = -(Q o Xref)`` per knot and ``pterm = -Pinf^T Xref_{N-1}`` are the
    reference-dependent linear-cost terms (reference:
    src/tinympc/admm.cpp:81-84); ``rho (B,)`` each instance's penalty."""

    A: torch.Tensor        # (B, nx, nx)
    B: torch.Tensor        # (B, nx, nu)
    Kinf: torch.Tensor     # (B, nu, nx)
    Quu_inv: torch.Tensor  # (B, nu, nu)
    AmBKt: torch.Tensor    # (B, nx, nx)
    u_min: torch.Tensor    # (B, 1 | N-1, nu)
    u_max: torch.Tensor
    x_min: torch.Tensor    # (B, 1 | N, nx)
    x_max: torch.Tensor
    qc: torch.Tensor       # (B, N, nx)
    pterm: torch.Tensor    # (B, nx)
    rho: torch.Tensor      # (B,)
    dims: tuple = ()       # (nx, nu, N)

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def has_knot_bounds(self) -> bool:
        return self.x_min.shape[-2] > 1 or self.u_min.shape[-2] > 1


def _bound(b: torch.Tensor, Bn: int, knots: int, k: int, name: str):
    """``(B, k)`` or ``(B, knots, k)`` (or anything that broadcasts to it) as
    ``(rows, per_knot)``."""
    b = torch.as_tensor(b)
    if b.dim() == 2 and tuple(b.shape) == (Bn, k):
        b = b[:, None, :]
    elif b.dim() < 3:
        b = b.reshape((1,) * (3 - b.dim()) + tuple(b.shape))
    if b.dim() > 3:
        raise ValueError(f"{name}: expected (B, {k}) or (B, {knots}, {k})")
    return _rows(b.expand(Bn, b.shape[-2], k), knots, k)


def pad_hstream_problem(problem: Problem, cache: Cache,
                        dtype: Any = torch.float32) -> HStreamProblem:
    """Kernel operands from a batch-leading ``Problem``/``Cache`` (every
    field with a leading batch axis). Bounds that vary over the knots for
    any instance become per-knot schedules (all four alike); otherwise one
    row per instance. Runs where the tensors are."""
    f = lambda a: a.to(dtype)
    A = f(problem.A)
    Bn, nx = A.shape[0], A.shape[-1]
    nu = problem.B.shape[-1]
    N = problem.Xref.shape[-2]
    with torch.no_grad():
        Xref = f(problem.Xref).expand(Bn, N, nx)
        rows = {name: _bound(f(getattr(problem, name)), Bn, knots, k, name)
                for name, knots, k in (("u_min", N - 1, nu),
                                       ("u_max", N - 1, nu),
                                       ("x_min", N, nx), ("x_max", N, nx))}
        knot = any(per for _r, per in rows.values())
        bounds = {}
        for name, (r, _per) in rows.items():
            knots = N - 1 if name.startswith("u") else N
            bounds[name] = (r.expand(Bn, knots, r.shape[-1]) if knot
                            else r).contiguous()
        return HStreamProblem(
            A=A.contiguous(), B=f(problem.B).contiguous(),
            Kinf=f(cache.Kinf).contiguous(),
            Quu_inv=f(cache.Quu_inv).contiguous(),
            AmBKt=f(cache.AmBKt).contiguous(),
            qc=(-(Xref * f(problem.Q)[:, None, :])).contiguous(),
            pterm=ha._pterm(Xref, f(cache.Pinf)).contiguous(),
            rho=ha._rho_rows(cache.rho, Bn, dtype, A.device),
            dims=(nx, nu, N), **bounds)


def hstream_ref_vectors(hsp: HStreamProblem, Q: torch.Tensor,
                        Pinf: torch.Tensor, Xref: torch.Tensor
                        ) -> HStreamProblem:
    """The reference-dependent operands for new horizon windows (per-instance
    tracking at long horizons; reference: quadrotor_tracking.cpp:101):
    ``Q (B, nx)`` raw cost diagonals, ``Pinf (B, nx, nx)``, ``Xref (B, N,
    nx)``. Returns ``hsp`` with ``qc``/``pterm`` replaced."""
    dt = hsp.qc.dtype
    nx, _nu, N = hsp.dims
    with torch.no_grad():
        Xref = Xref.to(dt).expand(hsp.batch, N, nx)
        return hsp.replace(
            qc=(-(Xref * Q.to(dt)[:, None, :])).contiguous(),
            pterm=ha._pterm(Xref, Pinf.to(dt)).contiguous())


def pad_hstream_from_plants(
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho: torch.Tensor, problem: Problem, dtype: Any = torch.float32,
    riccati: str = "auto",
) -> tuple[HStreamProblem, Cache]:
    """On-device build from raw plants: batched Riccati caches (reference
    math: src/tinympc/codegen.cpp:268-292; routed by ``riccati`` as in
    :func:`.hetero_admm.pad_hetero_from_plants`) and the operands."""
    _hp, caches = ha.pad_hetero_from_plants(A, B, Q, R, rho, problem, dtype,
                                            riccati)
    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    return pad_hstream_problem(prob_b, caches, dtype), caches


def hstream_carry_zeros(batch: int, hsp: HStreamProblem,
                        dtype=None) -> StreamCarry:
    """Cold-start carry (the stream tier's layout)."""
    return StreamCarry.zeros(batch, hsp, dtype)


def gather_hstream(hsp: HStreamProblem, carry: StreamCarry, x0: torch.Tensor,
                   idx: torch.Tensor, cone_params=None, cone_masks=None):
    """Instances ``idx`` of a problem, its carry, x0 and the per-instance
    cone operands -- the compaction primitive of
    :func:`..solver.cascade.hstream_cascade_solve`. Returns ``(hsp, carry,
    x0, cone_params, cone_masks)`` (the cone operands None where not
    given)."""
    take = lambda a: None if a is None else a.index_select(0, idx)
    hsp2 = HStreamProblem(**{k: take(v) for k, v in hsp.tensors().items()},
                          dims=hsp.dims)
    return (hsp2, StreamCarry(*(take(a) for a in carry)), take(x0),
            take(cone_params), take(cone_masks))


def hstream_solve_plain(
    x0: torch.Tensor, carry: StreamCarry, hsp: HStreamProblem, *,
    max_iter: int = 100, knot_block: int = 32, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    en_state_bound: bool = True, en_input_bound: bool = True, cones=None,
    cone_params=None, cone_masks=None,
) -> StreamResult:
    """Plain PyTorch version of :func:`hstream_solve` (which see), on any
    device and in float32 or float64 (the hetero tier's plain iteration)."""
    _check_common(max_iter, knot_block)
    ha._check_cone_args(cones, cone_params, cone_masks)
    return _plain(x0, carry, hsp, max_iter=max_iter,
                  check_termination=check_termination,
                  abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
                  en_input_bound=en_input_bound,
                  en_state_bound=en_state_bound, cones=cones,
                  cone_params=cone_params, cone_masks=cone_masks)


def hstream_solve(
    x0: torch.Tensor,
    carry: StreamCarry,
    hsp: HStreamProblem,
    *,
    max_iter: int = 100,
    knot_block: int = 32,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    en_state_bound: bool = True,
    en_input_bound: bool = True,
    cones=None,
    cone_params: torch.Tensor | None = None,
    cone_masks: torch.Tensor | None = None,
) -> StreamResult:
    """Heterogeneous-plant solve at long horizons.

    ``x0 (B, nx)``; ``carry`` the warm-start iterates
    (:class:`.stream_admm.StreamCarry`). Per instance the semantics of
    :func:`..solver.admm.solve` (reference: src/tinympc/admm.cpp:111-152).
    ``check_termination == 0`` runs the fixed-iteration kernel (K11), ``> 0``
    the adaptive kernel (K12) with per-instance convergence freezing every
    that many iterations (stats column 0 the iterations, column 1 the solved
    flag). ``cones`` adds SOC projections; ``cone_params`` ``(B, nc, 2)`` /
    ``cone_masks`` ``(B, MR)`` override their mu/shift and geometry per
    instance. ``knot_block`` changes nothing (:mod:`.stream_admm`).

    Tensors on the CPU go through :func:`hstream_solve_plain`; tensors on a
    CUDA device launch the kernel (float32, ``nx, nu <= 32``) or raise.
    """
    _check_common(max_iter, knot_block)
    ha._check_cone_args(cones, cone_params, cone_masks)
    kw = dict(max_iter=max_iter, check_termination=check_termination,
              abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
              en_input_bound=en_input_bound, en_state_bound=en_state_bound,
              cones=cones, cone_params=cone_params, cone_masks=cone_masks)
    if not x0.is_cuda:
        return _plain(x0, carry, hsp, **kw)
    return _launch("hstream_solve", False, x0, carry, hsp, **kw)
