"""Offline precompute: infinite-horizon Riccati cache + condensed horizon
operators: float64 numpy on the host, returned as tensors, and batched
tensor code on the device.

Counterpart of the JAX package's ``precompute.py`` (``riccati_cache`` and
``condensed_operators`` on the host, and the batched on-device routines
that keep the JAX names: ``riccati_cache_jax``, ``riccati_newton_jax``,
``riccati_polish_f64``, ``condensed_operators_jax``). The math half of the
reference's codegen (reference: src/tinympc/codegen.cpp:254-292): rho-augment the diagonal
costs, run the infinite-horizon discrete Riccati fixed point, cache the
matrices the ADMM solver needs.

:func:`condensed_operators` is the reformulation the fused kernels realize:
both horizon sweeps of the ADMM iteration (forward rollout, reference
src/tinympc/admm.cpp:27-37; backward Riccati gradient recursion,
admm.cpp:15-22) are *affine* recurrences, so each sweep collapses into one
dense product against a precomputed operator.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .types import DEFAULT_DEVICE, Cache

# Fixed-point controls (reference: src/tinympc/codegen.cpp:273-285).
RICCATI_MAX_ITERS = 1000
RICCATI_TOL = 1e-5


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def rho_augmented_costs(Q, R, rho):
    """Q += rho, R += rho elementwise on the diagonals (reference:
    src/tinympc/codegen.cpp:254-258)."""
    return Q + rho, R + rho


def riccati_cache(
    A, B, Q, R, rho: float,
    *,
    max_iters: int = RICCATI_MAX_ITERS,
    tol: float = RICCATI_TOL,
    dtype: Any = torch.float32,
    device: Any = DEFAULT_DEVICE,
) -> Cache:
    """Infinite-horizon Riccati fixed point in float64 on the host.

    Mirrors reference src/tinympc/codegen.cpp:268-292 exactly: P0 = rho*I,
    iterate Kinf/Pinf until max|dKinf| < 1e-5 (cap ``max_iters``), then cache
    Quu_inv, AmBKt, coeff_d2p. ``Q``/``R`` are the *raw* diagonal vectors;
    the rho augmentation happens here.
    """
    A = _np64(A)
    B = _np64(B)
    Qa, Ra = rho_augmented_costs(_np64(Q), _np64(R), float(rho))
    Q1 = np.diag(Qa)
    R1 = np.diag(Ra)

    nx, nu = B.shape
    Ktp1 = np.zeros((nu, nx))
    Ptp1 = float(rho) * np.eye(nx)
    Kinf = np.zeros((nu, nx))
    Pinf = np.zeros((nx, nx))
    for _ in range(max_iters):
        Kinf = np.linalg.solve(R1 + B.T @ Ptp1 @ B, B.T @ Ptp1 @ A)
        Pinf = Q1 + A.T @ Ptp1 @ (A - B @ Kinf)
        if np.max(np.abs(Kinf - Ktp1)) < tol:
            break
        Ktp1 = Kinf
        Ptp1 = Pinf

    Quu_inv = np.linalg.inv(R1 + B.T @ Pinf @ B)
    AmBKt = (A - B @ Kinf).T
    coeff_d2p = Kinf.T @ R1 - AmBKt @ Pinf @ B

    t = lambda m: torch.as_tensor(np.asarray(m, np.float64)).to(
        device=device, dtype=dtype)
    return Cache(
        rho=t(rho), Kinf=t(Kinf), Pinf=t(Pinf),
        Quu_inv=t(Quu_inv), AmBKt=t(AmBKt), coeff_d2p=t(coeff_d2p),
    )


class CondensedOperators(NamedTuple):
    """Dense affine operators condensing the two horizon sweeps.

    Forward rollout (reference src/tinympc/admm.cpp:27-37): with
    ``u_i = -Kinf x_i - d_i`` and ``x_{i+1} = A x_i + B u_i``, the closed
    loop is ``x_{i+1} = (A - B Kinf) x_i - B d_i`` -- affine in ``(x0, d)``:
    ``vec(x) = Fx0 @ x0 + Fd @ vec(d)``, ``vec(u) = Gx0 @ x0 + Gd @ vec(d)``.

    Backward gradient recursion (reference src/tinympc/admm.cpp:15-22):
    ``p_i = q_i + AmBKt p_{i+1} - Kinf^T r_i`` (terminal ``p_{N-1}`` given),
    ``d_i = Quu_inv (B^T p_{i+1} + r_i)`` -- affine in ``(q, r, p_{N-1})``:
    ``vec(p) = Hq @ vec(q_{0..N-2}) + Hr @ vec(r) + Hp @ p_{N-1}`` and
    ``vec(d) = Eq @ vec(q_{0..N-2}) + Er @ vec(r) + Ep @ p_{N-1}``.

    Shapes (N = horizon, m = N-1):
      Fx0 (N*nx, nx),  Fd (N*nx, m*nu),  Gx0 (m*nu, nx),  Gd (m*nu, m*nu)
      Hq (N*nx, m*nx), Hr (N*nx, m*nu),  Hp (N*nx, nx)
      Eq (m*nu, m*nx), Er (m*nu, m*nu),  Ep (m*nu, nx)
    """

    Fx0: torch.Tensor
    Fd: torch.Tensor
    Gx0: torch.Tensor
    Gd: torch.Tensor
    Hq: torch.Tensor
    Hr: torch.Tensor
    Hp: torch.Tensor
    Eq: torch.Tensor
    Er: torch.Tensor
    Ep: torch.Tensor


def condensed_operators(
    cache: Cache, A, B, horizon: int,
    *,
    dtype: Any = torch.float32,
    device: Any = DEFAULT_DEVICE,
) -> CondensedOperators:
    """Build the condensed horizon operators in float64 on the host."""
    A = _np64(A)
    B = _np64(B)
    K = _np64(cache.Kinf)
    AmBKt = _np64(cache.AmBKt)
    Quu_inv = _np64(cache.Quu_inv)
    Kt = K.T
    N = horizon
    m = N - 1
    nx, nu = B.shape
    Acl = A - B @ K  # closed-loop transition

    # --- forward: x_i as affine function of (x0, d) ---------------------------
    # x_0 = x0; x_{i+1} = Acl x_i - B d_i
    Fx0 = np.zeros((N * nx, nx))
    Fd = np.zeros((N * nx, m * nu))
    powers = [np.eye(nx)]
    for _ in range(N - 1):
        powers.append(Acl @ powers[-1])
    for i in range(N):
        Fx0[i * nx:(i + 1) * nx] = powers[i]
        for j in range(i):  # x_i depends on d_j for j < i
            Fd[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = -powers[i - 1 - j] @ B
    # u_i = -K x_i - d_i
    Gx0 = np.zeros((m * nu, nx))
    Gd = np.zeros((m * nu, m * nu))
    for i in range(m):
        Gx0[i * nu:(i + 1) * nu] = -K @ powers[i]
        Gd[i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = -np.eye(nu)
        for j in range(i):
            Gd[i * nu:(i + 1) * nu, j * nu:(j + 1) * nu] = -K @ (-powers[i - 1 - j] @ B)

    # --- backward: (p, d) as affine functions of (q_{0..N-2}, r, p_{N-1}) ----
    # p_{N-1} passes through; p_i = q_i + AmBKt p_{i+1} - K^T r_i, i = N-2..0
    Hq = np.zeros((N * nx, m * nx))
    Hr = np.zeros((N * nx, m * nu))
    Hp = np.zeros((N * nx, nx))
    Mpowers = [np.eye(nx)]  # AmBKt^k
    for _ in range(N - 1):
        Mpowers.append(AmBKt @ Mpowers[-1])
    Hp[(N - 1) * nx:] = np.eye(nx)
    for i in range(N - 1):
        Hp[i * nx:(i + 1) * nx] = Mpowers[N - 1 - i]
        for j in range(i, N - 1):
            Hq[i * nx:(i + 1) * nx, j * nx:(j + 1) * nx] = Mpowers[j - i]
            Hr[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = -Mpowers[j - i] @ Kt
    # d_i = Quu_inv (B^T p_{i+1} + r_i)
    QB = Quu_inv @ B.T
    Eq = np.zeros((m * nu, m * nx))
    Er = np.zeros((m * nu, m * nu))
    Ep = np.zeros((m * nu, nx))
    for i in range(m):
        Er[i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = Quu_inv
        r0 = (i + 1) * nx  # p_{i+1} rows of (Hq, Hr, Hp)
        Eq[i * nu:(i + 1) * nu] += QB @ Hq[r0:r0 + nx]
        Er[i * nu:(i + 1) * nu] += QB @ Hr[r0:r0 + nx]
        Ep[i * nu:(i + 1) * nu] = QB @ Hp[r0:r0 + nx]

    t = lambda mat: torch.as_tensor(mat).to(device=device, dtype=dtype)
    return CondensedOperators(
        Fx0=t(Fx0), Fd=t(Fd), Gx0=t(Gx0), Gd=t(Gd),
        Hq=t(Hq), Hr=t(Hr), Hp=t(Hp),
        Eq=t(Eq), Er=t(Er), Ep=t(Ep),
    )


# ------------------------------------------------- batched, on the device --
# The per-instance routines: a leading batch axis in place of the JAX
# package's vmap (an unbatched call is a batch of one). They are the plain
# versions of the Riccati kernels in :mod:`.ops.riccati_kernel`.

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _T(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _spd_solve(M: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """``M^{-1} Bm`` for batched small SPD ``M`` by Cholesky. An instance
    whose ``M`` is not positive definite or not finite comes back NaN (the
    factorisation does not raise), as the unrolled Cholesky of the kernels
    returns it."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0) | ~torch.isfinite(M).all(dim=(-2, -1))
    L = torch.where(bad[..., None, None], torch.eye(
        M.shape[-1], dtype=M.dtype, device=M.device).expand_as(L), L)
    X = torch.cholesky_solve(Bm, L)
    return torch.where(bad[..., None, None], torch.full_like(X, float("nan")), X)


def _batched(*arrays):
    """Give every argument a leading batch axis; returns (arrays, squeeze)."""
    A = arrays[0]
    if A.dim() == 2:
        return [None if a is None else a[None] for a in arrays], True
    return list(arrays), False


def _gain(A, B, R1, P):
    BtP = _mm(_T(B), P)
    M = R1 + _mm(BtP, B)
    # Symmetrise before the Cholesky solve: the recursion drifts P (and hence
    # R1 + B'PB) measurably asymmetric mid-iteration; the fixed point itself
    # is symmetric, so this changes nothing the stopping rule observes.
    return _spd_solve(0.5 * (M + _T(M)), _mm(BtP, A))


def _cache_terms(A, B, R1, rho, Kinf, Pinf) -> Cache:
    Mq = R1 + _mm(_mm(_T(B), Pinf), B)
    eye = torch.eye(B.shape[-1], dtype=A.dtype, device=A.device).expand_as(Mq)
    Quu_inv = _spd_solve(0.5 * (Mq + _T(Mq)), eye)
    AmBKt = _T(A - _mm(B, Kinf))
    coeff_d2p = _mm(_T(Kinf), R1) - _mm(AmBKt, _mm(Pinf, B))
    return Cache(rho=rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu_inv,
                 AmBKt=AmBKt, coeff_d2p=coeff_d2p)


def _frozen_loop(step, K, P, max_iters: int, tol: float):
    """Run ``step(K, P) -> (Knew, Pnew)`` on the whole batch until every
    instance has met ``max|Knew - K| < tol`` (or produced a non-finite step)
    or the cap: an instance stops being updated after the step that
    converged it, so what it returns is that step's iterate. Returns
    ``(K, P, iters)``."""
    Bn = K.shape[0]
    active = torch.ones((Bn,), dtype=torch.bool, device=K.device)
    iters = torch.zeros((Bn,), dtype=torch.int32, device=K.device)
    for _ in range(int(max_iters)):
        if not bool(active.any()):
            break
        Knew, Pnew = step(K, P)
        delta = (Knew - K).abs().amax(dim=(-2, -1))
        m = active[:, None, None]
        K = torch.where(m, Knew, K)
        P = torch.where(m, Pnew, P)
        iters = iters + active.to(torch.int32)
        active = active & (delta >= tol)   # a NaN delta ends the instance
    return K, P, iters


def riccati_fixed_point(A, B, Q, R, rho, *, max_iters=RICCATI_MAX_ITERS,
                        tol=RICCATI_TOL, P0=None, K0=None):
    """:func:`riccati_cache_jax` that also returns the per-instance
    iteration counts ``(B,)`` (int32)."""
    (A, B, Q, R, P0, K0), squeeze = _batched(A, B, Q, R, P0, K0)
    with torch.no_grad():
        dtype, dev = A.dtype, A.device
        Bn, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
        rho = torch.as_tensor(rho, dtype=dtype, device=dev).reshape(-1)
        rho = rho.expand(Bn) if rho.numel() == 1 else rho
        Qa, Ra = rho_augmented_costs(Q, R, rho[:, None])
        Q1, R1 = torch.diag_embed(Qa), torch.diag_embed(Ra)

        def step(K, P):
            Knew = _gain(A, B, R1, P)
            Pnew = Q1 + _mm(_T(A), _mm(P, A - _mm(B, Knew)))
            return Knew, 0.5 * (Pnew + _T(Pnew))

        K = (torch.zeros((Bn, nu, nx), dtype=dtype, device=dev)
             if K0 is None else K0.to(dtype))
        P = (rho[:, None, None] * torch.eye(nx, dtype=dtype, device=dev)
             if P0 is None else P0.to(dtype))
        K, P, iters = _frozen_loop(step, K, P, max_iters, tol)
        cache = _cache_terms(A, B, R1, rho, K, P)
    if squeeze:
        cache = Cache(**{k: v[0] for k, v in cache.tensors().items()})
        iters = iters[0]
    return cache, iters


def riccati_cache_jax(A, B, Q, R, rho, *, max_iters: int = RICCATI_MAX_ITERS,
                      tol: float = RICCATI_TOL, P0=None, K0=None) -> Cache:
    """On-device Riccati fixed point (same math as :func:`riccati_cache`),
    batched: ``A (B, nx, nx)``, ``B (B, nx, nu)``, ``Q (B, nx)``,
    ``R (B, nu)``, ``rho (B,)`` give a batch-leading :class:`Cache` (without
    the batch axis: one instance). The name is the JAX counterpart's.

    The reference's iteration cap and Kinf-delta stopping rule, per instance
    (an instance freezes at the step that converged it). Runs in the
    caller's dtype; prefer the host float64 path for offline cache builds.
    ``P0``/``K0`` warm-start the fixed point (e.g. from the cache at a nearby
    rho -- the adaptive-rho refresh case): the fixed point and stopping rule
    are unchanged; a warm start that is already converged exits after one
    verification step.
    """
    return riccati_fixed_point(A, B, Q, R, rho, max_iters=max_iters, tol=tol,
                               P0=P0, K0=K0)[0]


def riccati_newton(A, B, Q, R, rho, K0, *, tol=1e-9, max_outer=20,
                   inner_iters=18):
    """:func:`riccati_newton_jax` that also returns the per-instance outer
    step counts."""
    (A, B, Q, R, K0), squeeze = _batched(A, B, Q, R, K0)
    with torch.no_grad():
        dtype, dev = A.dtype, A.device
        Bn, nx = A.shape[0], A.shape[-1]
        rho = torch.as_tensor(rho, dtype=dtype, device=dev).reshape(-1)
        rho = rho.expand(Bn) if rho.numel() == 1 else rho
        Qa, Ra = rho_augmented_costs(Q, R, rho[:, None])
        Q1, R1 = torch.diag_embed(Qa), torch.diag_embed(Ra)

        def outer(K, _P):
            Mj = A - _mm(B, K)
            S = Q1 + _mm(_T(K), _mm(R1, K))
            for _ in range(int(inner_iters)):
                S = S + _mm(_T(Mj), _mm(S, Mj))
                Mj = _mm(Mj, Mj)
            Pn = 0.5 * (S + _T(S))
            return _gain(A, B, R1, Pn), Pn

        K, P, iters = _frozen_loop(
            outer, K0.to(dtype),
            torch.zeros((Bn, nx, nx), dtype=dtype, device=dev),
            max_outer, tol)
        cache = _cache_terms(A, B, R1, rho, K, P)
    if squeeze:
        cache = Cache(**{k: v[0] for k, v in cache.tensors().items()})
        iters = iters[0]
    return cache, iters


def riccati_newton_jax(A, B, Q, R, rho, K0, *, tol: float = 1e-9,
                       max_outer: int = 20, inner_iters: int = 18) -> Cache:
    """Batched Newton-Kleinman DARE solve from a stabilising warm gain
    ``K0`` (the plain counterpart of
    :func:`..ops.riccati_kernel.riccati_cache_newton`; see that docstring for
    the algorithm and the stabilising-warm-gain precondition). Each outer
    step solves the Stein equation by ``inner_iters`` squarings (effective
    horizon 2^inner_iters); quadratic outer convergence makes warm solves a
    handful of outer steps where the linear fixed point needs hundreds to
    thousands of iterations at tight ``tol`` on slow plants -- which is
    exactly the float64-polish regime. Where ``K0`` does not stabilise its
    plant the Stein sum diverges and that instance comes back non-finite."""
    return riccati_newton(A, B, Q, R, rho, K0, tol=tol, max_outer=max_outer,
                          inner_iters=inner_iters)[0]


def riccati_polish_f64(cache: Cache, A, B, Q, R, rho, *,
                       max_iters: int = RICCATI_MAX_ITERS, tol: float = 1e-9,
                       batch_chunk: int = 4096) -> Cache:
    """float64 polish of a device-built float32 cache batch.

    The float32 fixed point lands a few 1e-5 (relative) off the true cache,
    which moves controls past the 1e-4 parity bar. This runs
    Newton-Kleinman in float64 on the device from the converged float32 gain
    (always stabilising for its own plant, :func:`riccati_newton_jax`) to a
    tighter ``tol``, recomputes the cache terms in float64 and casts back:
    the returned caches are the correctly rounded float32 values of the true
    fixed point. Any instance whose Newton solve comes back non-finite
    (cannot happen for a truly converged warm gain; guarded anyway) is
    re-polished with the warm fixed point. Anchor: the reference's own
    double-precision insistence for the offline bake
    (examples/codegen_cartpole.cpp:9-11, glob_opts.hpp:3).

    ``batch_chunk`` bounds the float64 working set: larger batches run in
    chunks of at most this size.
    """
    f64 = lambda a: torch.as_tensor(a).to(torch.float64)
    A64, B64, Q64, R64 = f64(A), f64(B), f64(Q), f64(R)
    Bn = A64.shape[0]
    rho64 = f64(rho).reshape(-1).to(A64.device)
    rho64 = rho64.expand(Bn) if rho64.numel() == 1 else rho64
    P0, K0 = f64(cache.Pinf), f64(cache.Kinf)
    parts = []
    for lo in range(0, Bn, int(batch_chunk)):
        sl = slice(lo, min(lo + int(batch_chunk), Bn))
        out = riccati_newton_jax(A64[sl], B64[sl], Q64[sl], R64[sl],
                                 rho64[sl], K0[sl], tol=tol)
        bad = ~torch.stack([
            torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
            for v in out.tensors().values()]).all(dim=0)
        if bool(bad.any()):
            fb = riccati_cache_jax(
                A64[sl], B64[sl], Q64[sl], R64[sl], rho64[sl],
                P0=P0[sl], K0=K0[sl], max_iters=max_iters, tol=tol)
            out = Cache(**{
                k: torch.where(
                    bad.reshape((-1,) + (1,) * (v.dim() - 1)),
                    getattr(fb, k), v)
                for k, v in out.tensors().items()})
        parts.append(out)
    return Cache(**{
        k: torch.cat([getattr(p, k) for p in parts]).to(torch.float32)
        for k in parts[0].tensors()})


def condensed_operators_jax(cache: Cache, A, B, horizon: int
                            ) -> CondensedOperators:
    """On-device condensed-operator build (same math as
    :func:`condensed_operators`, which see for the derivation), batched:
    ``A (B, nx, nx)``, ``B (B, nx, nu)`` and a batch-leading ``cache`` give
    one operator set per instance (without the batch axis: one instance).
    This is the on-device half of the per-instance-plant tier; cost is
    O(N^2) small blocks, intended for MCU-class horizons."""
    squeeze = A.dim() == 2
    if squeeze:
        A, B = A[None], B[None]
        cache = Cache(**{k: v[None] for k, v in cache.tensors().items()})
    with torch.no_grad():
        K, AmBKt, Quu_inv = cache.Kinf, cache.AmBKt, cache.Quu_inv
        Kt = _T(K)
        N, m = int(horizon), int(horizon) - 1
        Bn, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
        z = lambda r, c: torch.zeros((Bn, r, c), dtype=A.dtype, device=A.device)
        eye = lambda n: torch.eye(n, dtype=A.dtype, device=A.device).expand(
            Bn, n, n)

        Acl = A - _mm(B, K)
        powers = [eye(nx)]
        for _ in range(N - 1):
            powers.append(_mm(Acl, powers[-1]))
        pB = [-_mm(p, B) for p in powers]  # -Acl^k B

        # forward: x_i = Acl^i x0 + sum_{j<i} Acl^{i-1-j} (-B) d_j;
        # u_i = -K x_i - d_i
        Fx0 = torch.cat(powers, dim=1)
        Fd, Gd = z(N * nx, m * nu), z(m * nu, m * nu)
        Gx0 = torch.cat([-_mm(K, powers[i]) for i in range(m)], dim=1)
        for i in range(N):
            for j in range(min(i, m)):
                Fd[:, i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = pB[i - 1 - j]
        for i in range(m):
            Gd[:, i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = -eye(nu)
            for j in range(i):
                Gd[:, i * nu:(i + 1) * nu, j * nu:(j + 1) * nu] = -_mm(
                    K, pB[i - 1 - j])

        # backward: p_i = sum_{j>=i} AmBKt^{j-i} (q_j - K^T r_j)
        #                 + AmBKt^{N-1-i} p_{N-1}
        Mp = [eye(nx)]
        for _ in range(N - 1):
            Mp.append(_mm(AmBKt, Mp[-1]))
        MpKt = [-_mm(p, Kt) for p in Mp]
        Hq, Hr = z(N * nx, m * nx), z(N * nx, m * nu)
        for i in range(N - 1):
            for j in range(i, m):
                Hq[:, i * nx:(i + 1) * nx, j * nx:(j + 1) * nx] = Mp[j - i]
                Hr[:, i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = MpKt[j - i]
        Hp = torch.cat([Mp[N - 1 - i] for i in range(N - 1)] + [eye(nx)], dim=1)

        # d_i = Quu_inv (B^T p_{i+1} + r_i)
        QB = _mm(Quu_inv, _T(B))
        Eq, Er, Ep = z(m * nu, m * nx), z(m * nu, m * nu), z(m * nu, nx)
        for i in range(m):
            r0 = (i + 1) * nx
            rows = slice(i * nu, (i + 1) * nu)
            Eq[:, rows] = _mm(QB, Hq[:, r0:r0 + nx])
            Er[:, rows] = _mm(QB, Hr[:, r0:r0 + nx])
            Er[:, rows, i * nu:(i + 1) * nu] += Quu_inv
            Ep[:, rows] = _mm(QB, Hp[:, r0:r0 + nx])
    out = CondensedOperators(Fx0=Fx0, Fd=Fd, Gx0=Gx0, Gd=Gd, Hq=Hq, Hr=Hr,
                             Hp=Hp, Eq=Eq, Er=Er, Ep=Ep)
    if squeeze:
        out = CondensedOperators(*(a[0] for a in out))
    return out
