"""Per-instance adaptive rho on the scan tier: any horizon, any nx.

Counterpart of the JAX package's ``solver/adaptive_scan.py``. The einsum
tier (:func:`.batched_ops.solve_adaptive_rho_batched`) carries O((N nu)^2)
condensed operators per instance and the hetero loop
(:mod:`.adaptive_hetero`) the kernels' size limits; this module runs the
same OSQP-style round loop (reference rho-in-the-cache anchor:
src/tinympc/codegen.cpp:254-292) with the iteration chunks on the scan tier
with per-instance plants (:func:`.batched.solve_batched`,
``problem_axes=BATCHED``) and the cache refresh on the batched builders of
:mod:`..precompute`: warm Newton-Kleinman (``riccati_newton_jax``) or the
warm fixed point. The scan tier consumes the :class:`..types.Cache`
directly, so a refresh needs no operand repack. Plain tensor code, as in
the JAX package: no kernel.

The round loop is the one the other two engines run
(:func:`.batched_ops.adaptive_rounds`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..precompute import riccati_cache_jax, riccati_newton_jax
from ..types import SOLVED, Cache, Problem, Settings, State
from .admm import _select
from .batched import BATCHED, init_state_batched, solve_batched
from .batched_ops import adaptive_rounds, refresh_changed


class AdaptiveScanResult(NamedTuple):
    state: State              # final batched solver state (warm-start ready)
    rho: torch.Tensor         # (B,) final per-instance rho
    cache: Cache              # batch-leading caches at the final rho
    solved: torch.Tensor      # (B,) bool
    total_iter: torch.Tensor  # (B,) int32
    rounds: int


def solve_adaptive_rho_scan(
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
    riccati: str = "newton",
    block: int = 0,
) -> AdaptiveScanResult:
    """OSQP-style per-instance rho adaptation on the scan tier (see module
    docstring). ``A/B/Q/R`` are per-instance ``(B, ...)`` plants, ``rho0
    (B,)``, ``problem`` batch-leading bounds and Xref. ``riccati``:
    ``"newton"`` (warm Newton-Kleinman, any nx) or ``"vmap"`` (warm fixed
    point). ``block > 0`` (block-condensed chunks) needs a shared plant and
    raises."""
    if riccati not in ("newton", "vmap"):
        raise ValueError(f"riccati must be 'newton' or 'vmap', got {riccati!r}")
    if block:
        raise NotImplementedError(
            "block-sweep chunks need a shared plant; per-instance plants "
            "use the scan sweeps (block=0)")
    batch = x0.shape[0]
    nx, nu = A.shape[-1], B.shape[-1]
    N = problem.Xref.shape[-2]

    def build_caches(rho, warm=None):
        if warm is None:
            return riccati_cache_jax(A, B, Q, R, rho)
        if riccati == "newton":
            return riccati_newton_jax(A, B, Q, R, rho, warm.Kinf, tol=1e-6)
        return riccati_cache_jax(A, B, Q, R, rho, P0=warm.Pinf, K0=warm.Kinf)

    def chunk_step(solved_in):
        nonlocal st, iters
        res = solve_batched(st, prob_b, caches, chunk_settings,
                            problem_axes=BATCHED, cache_axes=BATCHED)
        # Instances solved in an earlier round stay frozen verbatim.
        st = _select(solved_in, st, res)
        iters = torch.where(solved_in, iters,
                            iters + res.iter.to(torch.int32))
        return (solved_in | (res.status == SOLVED),
                torch.maximum(st.primal_residual_state,
                              st.primal_residual_input),
                torch.maximum(st.dual_residual_state, st.dual_residual_input))

    def rescale_duals(scale):
        nonlocal st
        st = st.replace(y=st.y * scale[:, None, None],
                        g=st.g * scale[:, None, None])

    def refresh(new_rho, changed):
        # Warm refresh; a round where nothing changed refreshes nothing.
        nonlocal caches
        if bool(changed.any()):
            caches = refresh_changed(
                caches, build_caches(new_rho, warm=caches), changed)

    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    chunk_settings = settings.replace(
        max_iter=chunk, check_termination=max(1, settings.check_termination))
    dt = A.dtype
    with torch.no_grad():
        rho = torch.as_tensor(rho0).to(device=x0.device, dtype=dt).reshape(
            -1).expand(batch).contiguous()
        caches = build_caches(rho)
        st = init_state_batched(batch, nx, nu, N, dt, x0.device)
        x = st.x.clone()
        x[:, 0, :] = x0.to(dt)
        st = st.replace(x=x)
        iters = torch.zeros((batch,), dtype=torch.int32, device=x0.device)
        rho, solved, rounds = adaptive_rounds(
            rho, max_rounds, chunk_step, rescale_duals, refresh,
            adapt_factor=adapt_factor, stall_factor=stall_factor,
            rho_min=rho_min, rho_max=rho_max)
    return AdaptiveScanResult(state=st, rho=rho, cache=caches, solved=solved,
                              total_iter=iters, rounds=rounds)
