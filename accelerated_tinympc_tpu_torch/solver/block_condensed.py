"""Block-condensed horizon sweeps: the shared-plant long-horizon tier.

Counterpart of the JAX package's ``solver/block_condensed.py``. The scan
tier's sweeps issue O(N) tiny products (an (nx, nx) matvec per knot), so at
long horizons they are bound by the latency of issuing them, not by FLOP.
This tier condenses each *block* of ``kb`` knots into dense affine operators
(the :class:`..precompute.CondensedOperators` math restricted to a block --
reference recursions: src/tinympc/admm.cpp:27-37 forward rollout, :15-22
backward gradient) and runs the sweeps over N/kb blocks of
``(B, kb*nu) @ (kb*nu, kb*nx)``-class products: kb times fewer sequential
steps for ~kb*nu/nx times the arithmetic of a forward block.

Iterates, elementwise stages and the ADMM loop semantics are exactly
:mod:`.admm`'s (this module only overrides the two horizon sweeps through
:func:`..solver.admm.admm_iteration`'s ``forward``/``backward`` hooks, like
the associative-scan tier); block boundaries change only the
floating-point summation order. Float32 products run in full float32 (the
module imports :mod:`.admm`, which switches TF32 off).

Use when N is large and the plant is SHARED across the batch: the operators
then stay in cache for every instance. With per-instance plants
(:func:`solve_block_batched`, ``TinyMPCFleet(tier="block")``) each
instance's operator set is read every iteration. ``block`` covers N-1 with
a tail block when ``kb`` does not divide N-1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import Cache, Problem, Settings, State
from .admm import _mv, solve
from .batched import BATCHED, solve_batched


class _BlockOps(NamedTuple):
    """Sliced condensed operators for one block size ``s`` (horizon s+1):
    forward ``x_{1..s} = Fx x_start + Fd d_blk``, ``u = Gx x_start + Gd
    d_blk``; backward ``d_blk = Eq q_blk + Er r_blk + Ep p_end``,
    ``p_{0..s-1} = Hq q_blk + Hr r_blk + Hp p_end``. A leading batch axis on
    every operator for per-instance plants."""

    Fx: torch.Tensor  # (s*nx, nx)
    Fd: torch.Tensor  # (s*nx, s*nu)
    Gx: torch.Tensor  # (s*nu, nx)
    Gd: torch.Tensor  # (s*nu, s*nu)
    Hq: torch.Tensor  # (s*nx, s*nx)
    Hr: torch.Tensor  # (s*nx, s*nu)
    Hp: torch.Tensor  # (s*nx, nx)
    Eq: torch.Tensor  # (s*nu, s*nx)
    Er: torch.Tensor  # (s*nu, s*nu)
    Ep: torch.Tensor  # (s*nu, nx)


def _slice_ops(o, s: int, nx: int) -> _BlockOps:
    return _BlockOps(
        Fx=o.Fx0[..., nx:, :], Fd=o.Fd[..., nx:, :], Gx=o.Gx0, Gd=o.Gd,
        Hq=o.Hq[..., : s * nx, :], Hr=o.Hr[..., : s * nx, :],
        Hp=o.Hp[..., : s * nx, :], Eq=o.Eq, Er=o.Er, Ep=o.Ep,
    )


def _ops_for_size(cache: Cache, A, B, s: int) -> _BlockOps:
    """Shared-plant operators built on the host in float64, then cast to
    the cache's dtype (float64 caches keep float64 operators: the float64
    exactness contract needs them unrounded)."""
    from ..precompute import condensed_operators

    nx = A.shape[-1]
    o = condensed_operators(cache, A, B, s + 1, dtype=cache.Kinf.dtype,
                            device=cache.Kinf.device)
    return _slice_ops(o, s, nx)


def block_sizes(horizon: int, block: int) -> tuple[int, int, int]:
    """``(kb, q, r)``: m = N-1 covered by q blocks of kb knots + a tail of
    r (kb clamped to m)."""
    m = int(horizon) - 1
    kb = max(1, min(int(block), m))
    q, r = divmod(m, kb)
    return kb, q, r


def _make_sweeps(ops_main, ops_tail, horizon: int, kb: int, nx: int,
                 nu: int):
    """``(forward, backward)`` sweep overrides; the operators are shared
    (2-D) or per instance (3-D, batch-leading), and the iterates carry any
    leading batch axes."""
    N = int(horizon)
    m = N - 1
    q, r = divmod(m, kb)

    def forward(state: State, problem: Problem, cache_: Cache) -> State:
        d = state.d
        lead = d.shape[:-2]
        xc = state.x[..., 0, :]
        us, xs = [], [state.x[..., :1, :]]
        blocks = [(ops_main, j * kb, kb) for j in range(q)]
        if r:
            blocks.append((ops_tail, q * kb, r))
        for o, start, s in blocks:
            db = d[..., start:start + s, :].reshape(lead + (s * nu,))
            U = _mv(o.Gx, xc) + _mv(o.Gd, db)
            X = _mv(o.Fx, xc) + _mv(o.Fd, db)
            xc = X[..., -nx:]
            us.append(U.reshape(lead + (s, nu)))
            xs.append(X.reshape(lead + (s, nx)))
        return state.replace(u=torch.cat(us, dim=-2), x=torch.cat(xs, dim=-2))

    def backward(state: State, problem: Problem, cache_: Cache) -> State:
        qv, rv = state.q, state.r
        lead = rv.shape[:-2]
        pc = state.p[..., -1, :]
        blocks = [(ops_main, j * kb, kb) for j in range(q)]
        if r:
            blocks.append((ops_tail, q * kb, r))
        ds, ps = [], []
        for o, start, s in reversed(blocks):
            Qb = qv[..., start:start + s, :].reshape(lead + (s * nx,))
            Rb = rv[..., start:start + s, :].reshape(lead + (s * nu,))
            D = _mv(o.Eq, Qb) + _mv(o.Er, Rb) + _mv(o.Ep, pc)
            P = _mv(o.Hq, Qb) + _mv(o.Hr, Rb) + _mv(o.Hp, pc)
            pc = P[..., :nx]
            ds.append(D.reshape(lead + (s, nu)))
            ps.append(P.reshape(lead + (s, nx)))
        return state.replace(
            d=torch.cat(ds[::-1], dim=-2),
            p=torch.cat(ps[::-1] + [state.p[..., -1:, :]], dim=-2),
        )

    return forward, backward


def block_sweeps(cache: Cache, A, B, horizon: int, block: int = 16):
    """``(forward, backward)`` sweep overrides for
    :func:`..solver.admm.admm_iteration`: shared plant, operators built on
    the host in float64. Any leading batch axes on the iterates."""
    kb, q, r = block_sizes(horizon, block)
    nx, nu = B.shape[-2:]
    ops_main = _ops_for_size(cache, A, B, kb) if q else None
    ops_tail = _ops_for_size(cache, A, B, r) if r else None
    return _make_sweeps(ops_main, ops_tail, horizon, kb, nx, nu)


def block_ops_batched(cache_b: Cache, A_b, B_b, horizon: int,
                      block: int = 16):
    """Per-instance block operators, built on the device
    (:func:`..precompute.condensed_operators_jax` per block size, batched).
    Returns ``(ops_main_b, ops_tail_b, kb)`` with a leading batch axis on
    every operator (either entry None when that size is absent). The
    dominant one is ``Hq (B, kb*nx, kb*nx)``: size kb to taste."""
    from ..precompute import condensed_operators_jax

    kb, q, r = block_sizes(horizon, block)
    nx = A_b.shape[-1]

    def build(s):
        return _slice_ops(condensed_operators_jax(cache_b, A_b, B_b, s + 1),
                          s, nx)

    return (build(kb) if q else None), (build(r) if r else None), kb


def solve_block_batched(
    state: State, problem_b: Problem, cache_b: Cache, settings: Settings,
    *, block: int = 16, project=None, ops=None,
) -> State:
    """Batched per-instance-plant solve with block-condensed sweeps
    (semantics per instance identical to
    :func:`..solver.batched.solve_batched` with ``problem_axes=BATCHED``);
    ``ops`` from :func:`block_ops_batched` can be passed prebuilt to
    amortize them across solves."""
    N = state.x.shape[-2]
    nx, nu = problem_b.B.shape[-2:]
    if ops is None:
        ops = block_ops_batched(cache_b, problem_b.A, problem_b.B, N, block)
    ops_main_b, ops_tail_b, kb = ops
    fwd, bwd = _make_sweeps(ops_main_b, ops_tail_b, N, kb, nx, nu)
    return solve_batched(state, problem_b, cache_b, settings,
                         problem_axes=BATCHED, cache_axes=BATCHED,
                         project=project, forward=fwd, backward=bwd)


def solve_block(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *, block: int = 16, project=None,
) -> State:
    """ADMM loop with block-condensed sweeps (same loop semantics as
    :func:`..solver.admm.solve`; reference src/tinympc/admm.cpp:111-152)."""
    N = state.x.shape[-2]
    forward, backward = block_sweeps(cache, problem.A, problem.B, N, block)
    return solve(state, problem, cache, settings, project=project,
                 forward=forward, backward=backward)
