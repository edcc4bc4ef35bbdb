"""Adaptive penalty (rho) scheduling -- an opt-in extension beyond the
reference.

Counterpart of the JAX package's ``solver/adaptive_rho.py``. The reference
fixes rho at problem-build time (reference: src/tinympc/codegen.cpp:254-258
bakes it into the cache; runtime never touches it). A badly chosen rho
leaves the primal/dual residuals unbalanced and ADMM crawling. This module
adds the standard OSQP-style remedy on top of the scan tier, periodically:

    rho <- clip(rho * sqrt(pri_res / dua_res), rho_min, rho_max)

updating only when BOTH (a) the residual imbalance exceeds ``adapt_factor``
(OSQP's ``adaptive_rho_tolerance``) and (b) progress has stalled (the max
residual stopped decaying between chunks) -- a well-chosen rho often shows a
persistently skewed ratio while converging at 100x per chunk, and touching
it would only destroy the contraction. Every update invalidates the Riccati
cache, which is recomputed **on the device**
(:func:`..precompute.riccati_cache_jax`), and the scaled duals are rescaled
(``y *= rho_old/rho_new``) so the underlying multipliers are preserved.

This is a host-driven outer loop around chunks of iterations (cache
recompute is rare and expensive relative to iterations); it is an offline/
setup-time tool for finding a good rho as much as a runtime solver.
"""

from __future__ import annotations

from typing import NamedTuple

from ..precompute import riccati_cache, riccati_cache_jax
from ..types import Cache, Problem, Settings, State
from . import admm


def _host_cache_sens(problem: Problem, rho: float, eps: float = 1e-4):
    """Float64 host Riccati cache at ``rho`` plus its d/drho by central
    differences -- the Taylor anchor for first-order adaptive caching.
    Differencing is per field; the ``rho`` field's derivative is exactly 1."""
    kw = dict(dtype=problem.A.dtype, device=problem.A.device)
    build = lambda r: riccati_cache(
        problem.A, problem.B, problem.Q, problem.R, r, **kw)
    c0, lo, hi = build(rho), build(rho * (1.0 - eps)), build(rho * (1.0 + eps))
    inv = 1.0 / (2.0 * eps * rho)
    dcache = Cache(**{k: (getattr(hi, k) - getattr(lo, k)) * inv
                      for k in c0.tensors()})
    return c0, dcache


class AdaptiveRhoResult(NamedTuple):
    state: State
    cache: Cache          # cache at the final rho (reusable for warm solves)
    rho: float
    iterations: int
    converged: bool
    rho_history: list


def solve_adaptive_rho(
    state: State,
    problem: Problem,
    cache: Cache,
    settings: Settings,
    *,
    chunk: int = 25,
    max_total_iter: int = 2000,
    adapt_factor: float = 5.0,
    stall_factor: float = 1.5,
    rho_min: float = 1e-2,
    rho_max: float = 1e3,
    f64_refresh: bool = False,
    first_order: bool = False,
    trust: float = 2.0,
) -> AdaptiveRhoResult:
    """Solve with periodic rho adaptation (single instance, scan tier).

    Runs ``chunk``-iteration segments; between segments, if progress has
    stalled and the primal/dual residual imbalance exceeds ``adapt_factor``,
    rescales rho and the duals and recomputes the Riccati cache on the
    device. Terminates on the ``settings`` tolerances or ``max_total_iter``.

    ``f64_refresh=True`` recomputes the post-update cache on the host in
    float64 (:func:`..precompute.riccati_cache`) instead of on the device in
    the problem dtype -- the reference insists the Riccati precompute run in
    double for robustness on ill-conditioned plants (reference:
    examples/codegen_cartpole.cpp:9-11); the on-device refresh is adequate
    for well-conditioned plants.

    ``first_order=True`` replaces the Riccati re-solve with first-order
    adaptive caching (PAPERS.md "First-Order Adaptive Caching"): the cache
    refreshes as ``C(rho) ~= C(c) + dC/drho * (rho - c)`` from float64
    central-difference sensitivities at the Taylor center ``c``,
    re-anchoring (one exact float64 rebuild + sensitivity) only when rho
    leaves ``[c/trust, c*trust]``. For the batched per-instance form see
    :func:`.batched_ops.solve_adaptive_rho_batched`.
    """
    pri_tol = float(settings.abs_pri_tol)
    dua_tol = float(settings.abs_dua_tol)
    # Residuals recorded every iteration; zero tolerance disables early exit
    # inside a chunk (the outer loop owns termination).
    chunk_settings = settings.replace(
        abs_pri_tol=0.0, abs_dua_tol=0.0, max_iter=chunk, check_termination=1
    )
    dtype, device = problem.A.dtype, problem.A.device
    rho = float(cache.rho)
    anchor = None  # (center, cache(center), dcache/drho) for first_order
    history = [rho]
    total = 0
    converged = False
    prev_max_res = float("inf")
    while total < max_total_iter:
        state = admm.solve(state, problem, cache, chunk_settings)
        total += chunk
        pri = float(max(state.primal_residual_state,
                        state.primal_residual_input))
        dua = float(max(state.dual_residual_state, state.dual_residual_input))
        if pri < pri_tol and dua < dua_tol:
            converged = True
            break
        max_res = max(pri, dua)
        stalled = max_res * stall_factor > prev_max_res
        prev_max_res = max_res
        ratio = (max(pri, 1e-12) / max(dua, 1e-12)) ** 0.5
        if stalled and (ratio > adapt_factor or ratio < 1.0 / adapt_factor):
            new_rho = float(min(max(rho * ratio, rho_min), rho_max))
            if new_rho != rho:
                scale = rho / new_rho
                state = state.replace(y=state.y * scale, g=state.g * scale)
                if first_order:
                    if anchor is None or not (
                        anchor[0] / trust <= new_rho <= anchor[0] * trust
                    ):
                        anchor = (new_rho, *_host_cache_sens(problem, new_rho))
                    c, cache0, dcache = anchor
                    delta = new_rho - c
                    cache = Cache(**{
                        k: getattr(cache0, k) + getattr(dcache, k) * delta
                        for k in cache0.tensors()})
                elif f64_refresh:
                    cache = riccati_cache(
                        problem.A, problem.B, problem.Q, problem.R, new_rho,
                        dtype=dtype, device=device)
                else:
                    cache = riccati_cache_jax(
                        problem.A, problem.B, problem.Q, problem.R, new_rho)
                    cache = cache.replace(rho=cache.rho.reshape(()))
                rho = new_rho
                history.append(rho)
                prev_max_res = float("inf")  # fresh contraction after swap
    return AdaptiveRhoResult(
        state=state, cache=cache, rho=rho, iterations=total,
        converged=converged, rho_history=history,
    )
