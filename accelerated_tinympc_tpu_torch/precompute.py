"""Offline precompute: infinite-horizon Riccati cache + condensed horizon
operators, float64 numpy on the host, returned as tensors.

Counterpart of the JAX package's ``precompute.py`` (``riccati_cache`` and
``condensed_operators``; the on-device batched variants come with the
per-instance-plant tiers). The math half of the reference's codegen
(reference: src/tinympc/codegen.cpp:254-292): rho-augment the diagonal
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
