"""Associative-scan horizon sweeps: the long-horizon (sequence-parallel) tier.

Counterpart of the JAX package's ``solver/assoc_scan.py``. The reference's
two horizon sweeps are sequential loops of dependent matvecs (reference:
src/tinympc/admm.cpp:27-37 forward rollout, :15-22 backward gradient
recursion). Both are *affine* recurrences:

    forward:   x_{i+1} = Acl x_i + b_i,   Acl = A - B Kinf,  b_i = -B d_i
    backward:  p_i     = M p_{i+1} + c_i, M = AmBKt,        c_i = q_i - Kinf^T r_i

Affine maps compose associatively ((A2,b2)o(A1,b1) = (A2 A1, A2 b1 + b2)), so
each sweep is a prefix scan of depth O(log N). JAX runs it as
``lax.associative_scan``; here it is a Hillis-Steele doubling over
``torch.matmul`` (``ceil(log2 N)`` rounds of batched products), which is
the same composition tree up to the grouping of the sums. Extra work is
O(N nx^3 log N) FLOP in exchange for O(log N) sequential steps.

Semantics identical to the scan tier (same dropped coeff_d2p term etc.).
The sweeps take any leading batch axes, like the stages of :mod:`.admm`.
Use via ``admm_iteration(..., forward=forward_pass_assoc,
backward=backward_pass_assoc)`` or :func:`solve_assoc`.
"""

from __future__ import annotations

import torch

from ..types import Cache, Problem, Settings, State
from .admm import solve


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` with both broadcast over their leading axes."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _compose(l, r):
    """Composition of affine maps: apply ``l`` (earlier) then ``r``."""
    Al, bl = l
    Ar, br = r
    return torch.matmul(Ar, Al), _mv(Ar, bl) + br


def _prefix(A: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix compositions ``prefix_i = f_i o ... o f_0`` of the
    maps ``f_i = (A[..., i, :, :], b[..., i, :])`` by doubling: round k
    composes each element with the one ``2**k`` before it."""
    n = b.shape[-2]
    off = 1
    while off < n:
        An, bn = _compose((A[..., :-off, :, :], b[..., :-off, :]),
                          (A[..., off:, :, :], b[..., off:, :]))
        A = torch.cat([A[..., :off, :, :], An], dim=-3)
        b = torch.cat([b[..., :off, :], bn], dim=-2)
        off *= 2
    return A, b


def forward_pass_assoc(state: State, problem: Problem, cache: Cache) -> State:
    """Parallel-prefix LQR rollout (semantics of reference admm.cpp:27-37)."""
    d = state.d
    m = d.shape[-2]
    Acl = problem.A - torch.matmul(problem.B, cache.Kinf)
    b = -_mv(problem.B.unsqueeze(-3), d)                      # (..., m, nx)
    A_elems = Acl.unsqueeze(-3).expand(
        Acl.shape[:-2] + (m,) + Acl.shape[-2:])
    Ap, bp = _prefix(A_elems, b)
    x0 = state.x[..., 0, :]
    x_tail = _mv(Ap, x0.unsqueeze(-2)) + bp
    x = torch.cat([x0.unsqueeze(-2), x_tail], dim=-2)
    u = -_mv(cache.Kinf.unsqueeze(-3), x[..., :-1, :]) - d
    return state.replace(x=x, u=u)


def backward_pass_assoc(state: State, problem: Problem, cache: Cache) -> State:
    """Parallel-suffix Riccati gradient recursion (semantics of reference
    admm.cpp:15-22; coeff_d2p term dropped as there)."""
    r = state.r
    m = r.shape[-2]
    M = cache.AmBKt
    Kt = cache.Kinf.transpose(-1, -2)
    c = state.q[..., :-1, :] - _mv(Kt.unsqueeze(-3), r)       # (..., m, nx)
    A_elems = M.unsqueeze(-3).expand(M.shape[:-2] + (m,) + M.shape[-2:])
    # suffix_i = f_i o f_{i+1} o ... o f_{m-1}  =>  p_i = suffix_i(p_{N-1}):
    # a prefix scan of the flipped sequence, flipped back.
    Ap, bp = _prefix(torch.flip(A_elems, dims=(-3,)), torch.flip(c, (-2,)))
    Ap, bp = torch.flip(Ap, dims=(-3,)), torch.flip(bp, dims=(-2,))
    p_term = state.p[..., -1, :]
    p_head = _mv(Ap, p_term.unsqueeze(-2)) + bp
    p = torch.cat([p_head, p_term.unsqueeze(-2)], dim=-2)
    # d_i = Quu_inv (B^T p_{i+1} + r_i)
    Bt = problem.B.transpose(-1, -2)
    d = _mv(cache.Quu_inv.unsqueeze(-3),
            _mv(Bt.unsqueeze(-3), p[..., 1:, :]) + r)
    return state.replace(p=p, d=d)


def solve_assoc(state: State, problem: Problem, cache: Cache,
                settings: Settings) -> State:
    """ADMM loop with associative-scan sweeps (same loop semantics as
    :func:`..solver.admm.solve`)."""
    return solve(state, problem, cache, settings,
                 forward=forward_pass_assoc, backward=backward_pass_assoc)
