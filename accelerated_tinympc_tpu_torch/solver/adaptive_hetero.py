"""Per-instance adaptive rho on the heterogeneous-plant kernels.

Counterpart of the JAX package's ``solver/adaptive_hetero.py``.
:func:`.batched_ops.solve_adaptive_rho_batched` runs its iteration chunks on
the per-instance-operator tier, which reads every instance's condensed
operators (~13 KB at nx=12, nu=4, N=10) each iteration. A per-instance rho is
just a per-instance cache, which is the layout of :mod:`..ops.hetero_admm`:
this module runs the same OSQP-style stall-guarded adaptation (reference
rho-in-the-cache anchor: src/tinympc/codegen.cpp:254-292 bakes rho into
Q1/R1 and the Riccati cache; the adaptation re-runs that bake per instance)
with the iteration chunks on the adaptive hetero kernel (K8), the cache
refresh on the Riccati kernels (K6 Newton-Kleinman or K5 fixed point) and
the operand repack limited to the cache fields
(:func:`..ops.hetero_admm.repack_hetero_caches`).

The round loop is the one ``solve_adaptive_rho_batched`` runs
(:func:`.batched_ops.adaptive_rounds`): chunked iterations with
per-instance freezing, the stall x imbalance guard, the sqrt(pri/dua)
rescale, the dual rescale by rho_old/rho_new, a warm refresh of the changed
instances only, and instances solved in an earlier round frozen verbatim.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops import riccati_kernel as rk
from ..ops.hetero_admm import (
    HeteroCarry,
    hetero_solve,
    pad_hetero_problem,
    repack_hetero_caches,
)
from ..types import Cache, Problem, Settings
from .batched_ops import adaptive_rounds, refresh_changed


class AdaptiveHeteroResult(NamedTuple):
    U: torch.Tensor           # (B, N-1, nu) final pre-projection controls
    X: torch.Tensor           # (B, N, nx)
    rho: torch.Tensor         # (B,) final per-instance rho
    cache: Cache              # batch-leading caches at the final rho
    solved: torch.Tensor      # (B,) bool
    total_iter: torch.Tensor  # (B,) int32
    rounds: int
    carry: Any                # HeteroCarry (warm-start ready)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def solve_adaptive_rho_hetero(
    x0: torch.Tensor,
    problem: Problem,
    A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
    rho0: torch.Tensor,
    settings: Settings,
    *,
    chunk: int = 25,
    max_rounds: int = 40,
    adapt_factor: float = 5.0,
    stall_factor: float = 1.5,
    rho_min: float = 1e-2,
    rho_max: float = 1e3,
    riccati: str = "auto",
    cones=None,
    cone_params: torch.Tensor | None = None,
    cone_masks: torch.Tensor | None = None,
) -> AdaptiveHeteroResult:
    """OSQP-style per-instance rho adaptation on the hetero kernels (see
    module docstring). Arguments mirror
    :func:`.batched_ops.solve_adaptive_rho_batched` (``A/B/Q/R (B, ...)``
    per-instance plants, ``rho0 (B,)``, ``problem`` batch-leading bounds and
    Xref); ``cones`` with hetero-layout ``cone_params``/``cone_masks`` add
    the kernels' cone projections.

    ``riccati`` routes the Riccati builds as the JAX package does: for
    plants the Riccati kernels take (``nx <= 16``, ``nu <= 8``),
    ``"kernel"`` is the fixed-point kernel K5 (warm refreshes from the
    previous caches), ``"newton"`` and ``"auto"`` (on CUDA tensors) the K5
    initial build and Newton-Kleinman refreshes K6; otherwise, and for
    ``"vmap"`` and ``"auto"`` on the CPU, the batched tensor code of
    :mod:`..precompute` (``"newton"`` then refreshes with its Newton
    solve)."""
    from ..precompute import riccati_cache_jax, riccati_newton_jax

    if getattr(settings, "alpha", 1.0) != 1.0:
        raise ValueError(
            "Settings.alpha is not implemented on the hetero kernel chunks "
            "(reference alpha=1 schedule); use solve_adaptive_rho_scan"
        )
    if riccati not in ("auto", "kernel", "newton", "vmap"):
        raise ValueError(f"unknown riccati mode {riccati!r}")
    batch = x0.shape[0]
    nx, nu = A.shape[-1], B.shape[-1]
    check_every = max(1, settings.check_termination)
    fits = nx <= rk.MAX_NX and nu <= rk.MAX_NU
    use_kernel = (riccati in ("kernel", "newton") and fits) or (
        riccati == "auto" and fits and A.is_cuda)

    def build_caches(rho, warm=None):
        if riccati == "newton" and not fits and warm is not None:
            return riccati_newton_jax(A, B, Q, R, rho, warm.Kinf, tol=1e-6)
        if use_kernel:
            if riccati in ("newton", "auto") and warm is not None:
                return rk.riccati_cache_newton(A, B, Q, R, rho, warm.Kinf)
            return rk.riccati_cache_kernel(
                A, B, Q, R, rho,
                P0=None if warm is None else warm.Pinf,
                K0=None if warm is None else warm.Kinf)
        if warm is None:
            return riccati_cache_jax(A, B, Q, R, rho)
        return riccati_cache_jax(A, B, Q, R, rho, P0=warm.Pinf, K0=warm.Kinf)

    def chunk_step(solved_in):
        nonlocal carry, U, X, acc_pri, acc_dua, iters
        res = hetero_solve(
            x0, carry, hp, max_iter=chunk, check_termination=check_every,
            abs_pri_tol=settings.abs_pri_tol,
            abs_dua_tol=settings.abs_dua_tol,
            en_input_bound=settings.en_input_bound,
            en_state_bound=settings.en_state_bound,
            cones=cones, cone_params=cone_params, cone_masks=cone_masks)
        st = res.stats
        # Instances solved in an earlier round stay frozen verbatim (the
        # kernel re-solved them from the warm carry; that is discarded).
        carry = HeteroCarry(*(_where(solved_in, o, n)
                              for o, n in zip(carry, res.carry)))
        U = _where(solved_in, U, res.U)
        X = _where(solved_in, X, res.X)
        acc_pri = torch.where(solved_in, acc_pri,
                              torch.maximum(st[:, 2], st[:, 4]))
        acc_dua = torch.where(solved_in, acc_dua,
                              torch.maximum(st[:, 3], st[:, 5]))
        iters = torch.where(solved_in, iters,
                            iters + st[:, 0].to(torch.int32))
        return solved_in | (st[:, 1] > 0.5), acc_pri, acc_dua

    def rescale_duals(scale):
        nonlocal carry
        carry = carry._replace(y=carry.y * scale[:, None, None],
                               g=carry.g * scale[:, None, None])

    def refresh(new_rho, changed):
        # Warm refresh + cache-only repack; a round where nothing changed
        # refreshes nothing.
        nonlocal caches, hp
        if bool(changed.any()):
            caches = refresh_changed(
                caches, build_caches(new_rho, warm=caches), changed)
            hp = repack_hetero_caches(hp, caches, Xref)

    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    dt = A.dtype
    with torch.no_grad():
        rho = torch.as_tensor(rho0).to(device=x0.device, dtype=dt).reshape(
            -1).expand(batch).contiguous()
        caches = build_caches(rho)
        hp = pad_hetero_problem(prob_b, caches, dt)
        Xref = prob_b.Xref.to(dt)
        carry = HeteroCarry.zeros(hp)
        N = hp.dims[2]
        U = torch.zeros((batch, N - 1, nu), dtype=dt, device=x0.device)
        X = torch.zeros((batch, N, nx), dtype=dt, device=x0.device)
        acc_pri = torch.zeros((batch,), dtype=dt, device=x0.device)
        acc_dua = torch.zeros_like(acc_pri)
        iters = torch.zeros((batch,), dtype=torch.int32, device=x0.device)
        rho, solved, rounds = adaptive_rounds(
            rho, max_rounds, chunk_step, rescale_duals, refresh,
            adapt_factor=adapt_factor, stall_factor=stall_factor,
            rho_min=rho_min, rho_max=rho_max)
    return AdaptiveHeteroResult(
        U=U, X=X, rho=rho, cache=caches, solved=solved, total_iter=iters,
        rounds=rounds, carry=carry)
