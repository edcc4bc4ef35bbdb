"""CUDA kernels: batched infinite-horizon Riccati precompute.

Counterpart of the JAX package's ``ops/riccati_kernel.py``. The reference
runs its Riccati fixed point once, offline, in double on a host (reference:
src/tinympc/codegen.cpp:268-292). Here it runs *per instance, on the device*:
on-device plant sweeps (:func:`..solver.batched_ops.
build_instance_ops_from_plants`) and the adaptive-rho exact refresh
(:func:`..solver.batched_ops.solve_adaptive_rho_batched`) build thousands of
caches at once. As batched tensor code (:func:`..precompute.
riccati_cache_jax`) every step is a dozen launches of 12x12-class products;
the kernels (``csrc/riccati.cu``) keep each instance's matrices on the SM
for the whole iteration: for the sizes in :data:`GROUP_SHAPES` a group of
lanes owns an instance's columns in registers, every other size runs the
general kernel (one warp per instance) as far as shared memory takes it
(:func:`kernel_plan`).

Semantics match :func:`..precompute.riccati_cache_jax` per instance: P0 =
rho*I (or a warm ``P0``/``K0``), iterate Kinf/Pinf until ``max|dKinf| < tol``
(cap ``max_iters``; the reference's stopping rule, codegen.cpp:273-285), an
instance stops at the step that converged it (the returned iterates are the
reference's, not further ones), then Quu_inv, AmBKt, coeff_d2p from the
frozen fixed point.

Each entry point takes its plain version (:func:`riccati_cache_kernel_plain`,
:func:`riccati_cache_newton_plain`) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The kernels also return each
instance's step count (the TPU kernels compute it and drop it):
:func:`riccati_fixed_point_kernel` and :func:`riccati_newton_kernel` return
``(cache, iters)``, the ``riccati_cache_*`` functions the cache alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..precompute import riccati_fixed_point, riccati_newton
from ..types import Cache

# Launches per kernel, counted where (and only where) a wrapper launches it.
LAUNCH_COUNTS = {"riccati_fixed_point": 0, "riccati_newton": 0}

# The lane-group instantiations of csrc/riccati.cu (ATM_RIC_SHAPES): lanes
# per instance for each (nx, nu). Every other size runs the general kernel.
GROUP_SHAPES = {(12, 4): 4, (6, 3): 2, (8, 3): 4, (6, 8): 2, (5, 2): 1}
THREADS = 128                 # per block, both designs
SMEM_LIMIT_BYTES = 232_448    # what a Hopper block may take


class KernelPlan(NamedTuple):
    """How one launch runs: ``group`` lanes per instance (0: the general
    kernel, one warp per instance), ``per_block`` instances per block and
    the block's dynamic shared memory."""

    group: int
    per_block: int
    smem_bytes: int


def _r4(n: int) -> int:
    return (n + 3) & ~3


def kernel_plan(nx: int, nu: int, newton: bool = False,
                limit: int = SMEM_LIMIT_BYTES) -> KernelPlan:
    """Mirrors ``ric_plan`` in ``csrc/riccati.cu`` (the C entry refuses a
    launch whose bytes differ). The lane-group kernel for the shapes of
    :data:`GROUP_SHAPES`: per instance P, A and an exchange buffer by
    columns, B by rows and B'P by columns (Newton also M_j and K), each slice
    4 mod 32 floats long. Else the general kernel with as many warps (at
    most 4) as fit ``limit``. Raises with the bytes one instance needs when
    not even one fits."""
    G = GROUP_SHAPES.get((nx, nu))
    if G is not None:
        mats = (4 if newton else 3) * nx * _r4(nx) + (
            3 if newton else 2) * nx * _r4(nu)
        stride = mats + (36 - mats % 32) % 32
        return KernelPlan(G, THREADS // G, THREADS // G * stride * 4)
    per_warp = 4 * (5 * nx * nx + 5 * nu * nx + 2 * nu * nu + nx + nu)
    warps = min(THREADS // 32, limit // per_warp)
    if warps < 1:
        raise ValueError(
            f"the Riccati kernels need {per_warp} bytes of shared memory for "
            f"one instance at nx={nx}, nu={nu} (limit {limit}); use "
            "precompute.riccati_cache_jax (riccati='vmap' in "
            "solver.batched_ops)")
    return KernelPlan(0, warps, warps * per_warp)


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("riccati")
    if not getattr(lib, "_atm_declared", False):
        lib.atm_riccati_fixed_point.argtypes = (
            [_P] * 13 + [_I] * 4 + [_F] + [_I] * 2 + [_P])
        lib.atm_riccati_fixed_point.restype = _I
        lib.atm_riccati_newton.argtypes = (
            [_P] * 12 + [_I] * 5 + [_F] + [_I] * 2 + [_P])
        lib.atm_riccati_newton.restype = _I
        lib._atm_declared = True
    return lib


def _prepare(A, B, Q, R, rho):
    """Shapes checked, float32, contiguous, rho broadcast to ``(Bn,)``."""
    if A.dim() != 3 or B.dim() != 3:
        raise ValueError("A must be (B, nx, nx) and B (B, nx, nu)")
    Bn, nx, _ = A.shape
    nu = B.shape[-1]
    dev = A.device
    f = lambda a, shape, name: _shaped(a, shape, name, dev)
    A = f(A, (Bn, nx, nx), "A")
    B = f(B, (Bn, nx, nu), "B")
    Q = f(Q, (Bn, nx), "Q")
    R = f(R, (Bn, nu), "R")
    rho = torch.as_tensor(rho, dtype=torch.float32, device=dev).reshape(-1)
    if rho.numel() == 1:
        rho = rho.expand(Bn)
    rho = f(rho, (Bn,), "rho")
    return A, B, Q, R, rho, Bn, nx, nu


def _shaped(a, shape, name, dev):
    a = torch.as_tensor(a, device=dev)
    if a.device != dev:
        raise ValueError(f"{name} is on {a.device}, expected {dev}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
    return a.to(torch.float32).contiguous()


def _outputs(Bn, nx, nu, dev):
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    return (new(Bn, nu, nx), new(Bn, nx, nx), new(Bn, nu, nu),
            new(Bn, nx, nx), new(Bn, nx, nu),
            torch.empty((Bn,), dtype=torch.int32, device=dev))


def _launch_plan(dev, nx: int, nu: int, newton: bool):
    """``(plan, limit)`` on this device; raises where nothing fits."""
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT_BYTES)
    return kernel_plan(nx, nu, newton, limit), limit


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: sizes or shared-memory plan refused by "
                           "the kernel entry")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _f32(a):
    return None if a is None else torch.as_tensor(a).to(torch.float32)


def _fixed_point_plain(A, B, Q, R, rho, max_iters, tol, P0, K0):
    return riccati_fixed_point(
        _f32(A), _f32(B), _f32(Q), _f32(R), _f32(rho), max_iters=max_iters,
        tol=tol, P0=_f32(P0), K0=_f32(K0))


def riccati_cache_kernel_plain(A, B, Q, R, rho, *, max_iters: int = 1000,
                               tol: float = 1e-5, P0=None, K0=None) -> Cache:
    """Plain PyTorch version of :func:`riccati_cache_kernel`: the batched
    fixed point of :func:`..precompute.riccati_fixed_point` in float32."""
    return _fixed_point_plain(A, B, Q, R, rho, max_iters, tol, P0, K0)[0]


def riccati_cache_kernel(A, B, Q, R, rho, *, max_iters: int = 1000,
                         tol: float = 1e-5, P0=None, K0=None) -> Cache:
    """The cache of :func:`riccati_fixed_point_kernel` (which see)."""
    return riccati_fixed_point_kernel(
        A, B, Q, R, rho, max_iters=max_iters, tol=tol, P0=P0, K0=K0)[0]


def riccati_fixed_point_kernel(A, B, Q, R, rho, *, max_iters: int = 1000,
                               tol: float = 1e-5, P0=None, K0=None):
    """Batched on-device Riccati precompute, one distinct plant per instance.

    ``A (B, nx, nx)``, ``B (B, nx, nu)``, ``Q (B, nx)`` / ``R (B, nu)`` raw
    cost diagonals, ``rho (B,)``. Returns a batch-leading
    :class:`..types.Cache` matching :func:`..precompute.riccati_cache_jax`
    per instance (same initialisation, stopping rule and per-instance freeze
    at convergence), and the steps each instance took, ``(B,)`` int32.
    ``P0``/``K0`` (both or neither) warm-start the fixed point. Any size
    whose one-instance working set fits a block's shared memory
    (:func:`kernel_plan`); larger sizes raise.
    """
    if (P0 is None) != (K0 is None):
        raise ValueError("warm start needs both P0 and K0")
    if not A.is_cuda:
        return _fixed_point_plain(A, B, Q, R, rho, max_iters, tol, P0, K0)
    A, B, Q, R, rho, Bn, nx, nu = _prepare(A, B, Q, R, rho)
    dev = A.device
    if P0 is not None:
        P0 = _shaped(P0, (Bn, nx, nx), "P0", dev)
        K0 = _shaped(K0, (Bn, nu, nx), "K0", dev)
    plan, limit = _launch_plan(dev, nx, nu, False)
    Kinf, Pinf, Quu, AmBKt, coeff, iters = _outputs(Bn, nx, nu, dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.atm_riccati_fixed_point(
            A.data_ptr(), B.data_ptr(), Q.data_ptr(), R.data_ptr(),
            rho.data_ptr(),
            None if P0 is None else P0.data_ptr(),
            None if K0 is None else K0.data_ptr(),
            Kinf.data_ptr(), Pinf.data_ptr(), Quu.data_ptr(),
            AmBKt.data_ptr(), coeff.data_ptr(), iters.data_ptr(),
            Bn, nx, nu, int(max_iters), float(tol), plan.smem_bytes, limit,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "riccati_cache_kernel")
    LAUNCH_COUNTS["riccati_fixed_point"] += 1
    return Cache(rho=rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu, AmBKt=AmBKt,
                 coeff_d2p=coeff), iters


def _newton_plain(A, B, Q, R, rho, K0, max_outer, inner_iters, tol):
    return riccati_newton(
        _f32(A), _f32(B), _f32(Q), _f32(R), _f32(rho), _f32(K0), tol=tol,
        max_outer=max_outer, inner_iters=inner_iters)


def riccati_cache_newton_plain(A, B, Q, R, rho, K0, *, max_outer: int = 12,
                               inner_iters: int = 13, tol: float = 1e-5
                               ) -> Cache:
    """Plain PyTorch version of :func:`riccati_cache_newton`: the batched
    Newton-Kleinman solve of :func:`..precompute.riccati_newton` in
    float32."""
    return _newton_plain(A, B, Q, R, rho, K0, max_outer, inner_iters, tol)[0]


def riccati_cache_newton(A, B, Q, R, rho, K0, *, max_outer: int = 12,
                         inner_iters: int = 13, tol: float = 1e-5) -> Cache:
    """The cache of :func:`riccati_newton_kernel` (which see)."""
    return riccati_newton_kernel(
        A, B, Q, R, rho, K0, max_outer=max_outer, inner_iters=inner_iters,
        tol=tol)[0]


def riccati_newton_kernel(A, B, Q, R, rho, K0, *, max_outer: int = 12,
                          inner_iters: int = 13, tol: float = 1e-5):
    """Batched Newton-Kleinman DARE solve -- the warm-refresh fast path.
    Returns ``(cache, outer steps per instance)``.

    Same arguments as :func:`riccati_cache_kernel` plus a **required**
    stabilising warm gain ``K0 (B, nu, nx)`` (any previously converged Kinf
    works at *any* rho: the closed loop A - B K0 does not depend on rho, so
    rho-only refreshes are unconditionally safe). If ``K0`` does NOT
    stabilise the given plant (possible when the *plant* changed), the Stein
    sum diverges and that instance's outputs come back non-finite --
    detectable per instance; callers that accept arbitrary plant updates
    must fall back to the fixed-point kernel for those instances. Each outer
    step solves the Stein equation ``P = M'PM + Q1 + K'R1K`` (M = A - BK) by
    ``inner_iters`` doublings (``S += Mj' S Mj; Mj = Mj^2``, an effective
    horizon of 2^inner_iters knots), then refreshes the gain.

    Semantics note: converges to the *true* DARE fixed point (to ``tol`` on
    max|dK|), not the reference's truncated fixed-point iterate
    (codegen.cpp:273-285) -- the two agree to ~tol. Use the fixed-point
    kernel where parity with the reference's cache path matters; use this
    for adaptive-rho refreshes, where rho-refreshed caches have no reference
    counterpart at all.
    """
    if not A.is_cuda:
        return _newton_plain(A, B, Q, R, rho, K0, max_outer, inner_iters,
                             tol)
    A, B, Q, R, rho, Bn, nx, nu = _prepare(A, B, Q, R, rho)
    dev = A.device
    K0 = _shaped(K0, (Bn, nu, nx), "K0", dev)
    plan, limit = _launch_plan(dev, nx, nu, True)
    Kinf, Pinf, Quu, AmBKt, coeff, iters = _outputs(Bn, nx, nu, dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.atm_riccati_newton(
            A.data_ptr(), B.data_ptr(), Q.data_ptr(), R.data_ptr(),
            rho.data_ptr(), K0.data_ptr(),
            Kinf.data_ptr(), Pinf.data_ptr(), Quu.data_ptr(),
            AmBKt.data_ptr(), coeff.data_ptr(), iters.data_ptr(),
            Bn, nx, nu, int(max_outer), int(inner_iters), float(tol),
            plan.smem_bytes, limit, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "riccati_cache_newton")
    LAUNCH_COUNTS["riccati_newton"] += 1
    return Cache(rho=rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu, AmBKt=AmBKt,
                 coeff_d2p=coeff), iters
