"""In-kernel receding-horizon rollout: the entire K-tick MPC mission in ONE
CUDA kernel launch.

Counterpart of the JAX package's ``ops/fused_rollout.py``. The
loop-of-kernels rollout (:func:`..api.mpc.fused_mpc_rollout`) pays, per
tick, a kernel launch and a round trip of every warm-start carry through
device memory -- which matters once the adaptive mode cuts warm ticks to a
few iterations. Here the tick loop itself runs inside the kernel
(``csrc/fused_admm.cu``, ``fused_rollout_kernel``): an instance's carry
(x0, D, Z, V) lives in its slot of a block's shared memory across ticks, and
each slot moves its own instance from tick to tick (no tick waits for other
instances): it resets the duals, runs the shared fixed/adaptive iteration
core, applies the pre-projection first-knot control to the plant, and writes
one trace row (u0 and the iteration count) per tick.

Per-tick semantics are exactly the reference receding-horizon loop
(reference: examples/quadrotor_hovering.cpp:90-114): measurement into
``x.col(0)``, dual reset y=g=0 (slacks and gains warm-start),
``tiny_solve``, apply *pre-projection* ``u.col(0)``, plant step
``x+ = A x + B u``. Tracking mode slides the reference window per tick
(quadrotor_tracking.cpp:101) through a per-tick ``const_d`` row -- the only
reference-dependent operand of the folded iteration.

Beside the kernel sits :func:`fused_rollout_plain`; :func:`fused_rollout`
takes it only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import DEFAULT_DEVICE, Problem
from .fused_admm import (
    LAUNCH_COUNTS,
    FusedCarry,
    FusedConeOps,
    FusedResult,
    PaddedProblem,
    _check,
    _cone_table,
    _geometry,
    _kernel_operands,
    _library,
    _raise_on,
    _unsupported,
    work_counter,
    fold_const_d,
    fused_solve_plain,
    ref_vectors,
)


class RolloutOps(NamedTuple):
    """Plant-step operators for the in-kernel rollout, transposed so that
    ``x+ = x @ W_A + u0 @ W_B0``: ``W_A (nx, nx) = A.T``,
    ``W_B0 (nu, nx) = B.T``. ``A``/``B`` are the kernel's row-major copies."""

    W_A: torch.Tensor
    W_B0: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor


def rollout_ops(problem: Problem, pp: PaddedProblem,
                dtype: Any = torch.float32,
                device: Any = DEFAULT_DEVICE) -> RolloutOps:
    """Build the plant operators on ``device``."""
    A = problem.A.to(device=device, dtype=dtype).contiguous()
    B = problem.B.to(device=device, dtype=dtype).contiguous()
    return RolloutOps(W_A=A.T.contiguous(), W_B0=B.T.contiguous(), A=A, B=B)


class RolloutResult(NamedTuple):
    """``x_final (B, nx)`` plant state after the last tick; ``us (T, B, nu)``
    applied (pre-projection) first-knot controls per tick; ``iters (T, B)``
    per-tick solve iteration counts (int32); ``final`` the last tick's
    :class:`..ops.fused_admm.FusedResult` (for warm-starting a continuation
    or inspecting residuals)."""

    x_final: torch.Tensor
    us: torch.Tensor
    iters: torch.Tensor
    final: FusedResult


def rollout_const_seq(
    pp: PaddedProblem, Q: torch.Tensor, Pinf: torch.Tensor,
    Xref_total: torch.Tensor, n_ticks: int,
) -> torch.Tensor:
    """Per-tick folded reference constants for tracking mode: tick ``t`` uses
    the window ``Xref_total[t:t+N]`` (reference: quadrotor_tracking.cpp:101).
    Returns ``(n_ticks, Du)`` rows of ``const_d`` (see
    :func:`.fused_admm.ref_vectors`)."""
    _nx, _nu, N = pp.dims
    Xref_total = torch.as_tensor(
        Xref_total, dtype=pp.xref_q.dtype, device=pp.xref_q.device)
    rows = []
    for t in range(n_ticks):
        xq, pc = ref_vectors(pp, Q, Pinf, Xref_total[t:t + N])
        rows.append(fold_const_d(pp, xq, pc)[0])
    return torch.stack(rows, dim=0)


def _validate(max_iter: int, n_ticks: int) -> None:
    if max_iter < 1:
        raise ValueError("at least one iteration per tick")
    if n_ticks < 1:
        raise ValueError("at least one tick")


def fused_rollout_plain(
    x0: torch.Tensor, carry: FusedCarry, pp: PaddedProblem, rops: RolloutOps,
    n_ticks: int, *,
    max_iter: int = 100, check_termination: int = 0,
    abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
    warmup_iters: int = 0, const_seq: torch.Tensor | None = None,
    alpha: float = 1.0, cone_ops: FusedConeOps | None = None,
) -> RolloutResult:
    """Plain PyTorch version of the in-kernel rollout: the kernel's tick loop
    on whole-batch tensors, each tick through :func:`fused_solve_plain`
    (with ``cone_ops``: coned solves)."""
    _validate(max_iter, n_ticks)
    with torch.no_grad():
        const_d = fold_const_d(pp) if const_seq is None else None
        x = x0
        us, iters = [], []
        res = None
        for t in range(int(n_ticks)):
            cd = const_d if const_seq is None else const_seq[t:t + 1]
            res = fused_solve_plain(
                x, carry.reset_duals(), pp, const_d=cd, max_iter=max_iter,
                check_termination=check_termination,
                abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
                warmup_iters=warmup_iters, alpha=alpha, cone_ops=cone_ops,
            )
            carry = res.carry
            u0 = res.U[:, : pp.dims[1]]
            us.append(u0)
            iters.append(res.stats[:, 0].to(torch.int32))
            x = torch.matmul(x, rops.W_A) + torch.matmul(u0, rops.W_B0)
        return RolloutResult(
            x_final=x, us=torch.stack(us), iters=torch.stack(iters),
            final=res)


def fused_rollout(
    x0: torch.Tensor,
    carry: FusedCarry,
    pp: PaddedProblem,
    rops: RolloutOps,
    n_ticks: int,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    warmup_iters: int = 0,
    batch_tile: int | None = None,
    const_seq: torch.Tensor | None = None,
    algo: str = "f32",
    polish: int = 8,
    cone_ops: FusedConeOps | None = None,
    alpha: float = 1.0,
    threads: int | None = None,
    placement: str | None = None,
    register_tile: int | None = None,
) -> RolloutResult:
    """Run ``n_ticks`` receding-horizon MPC ticks in one kernel launch.

    ``const_seq`` (``(n_ticks, Du)`` from :func:`rollout_const_seq`) streams
    a per-tick folded reference constant -- tracking mode; ``None`` uses the
    problem's baked constant (hovering). ``check_termination > 0`` runs each
    tick's solve in the adaptive core at the given tolerances (the warm-tick
    fast path); 0 = fixed ``max_iter`` iterations per tick. The incoming
    ``carry.Y``/``carry.G`` are not read: every tick starts from zero duals.
    ``cone_ops`` (:func:`.fused_admm.pad_cones`) appends exact
    second-order-cone projections to every tick's slack stage -- identical
    composition to :func:`.fused_admm.fused_solve` (coned powered-descent
    missions in one launch).
    Semantics per tick match :func:`..api.mpc.fused_mpc_rollout` (the
    loop-of-kernels implementation of the same loop).

    ``batch_tile``, ``threads``, ``placement`` and ``register_tile`` are
    the launch geometry, operator placement and register tile of
    :func:`.fused_admm.fused_solve`.

    Tensors on the CPU go through :func:`fused_rollout_plain`; tensors on a
    CUDA device launch the kernel (float32 only) or raise.
    """
    _unsupported(algo, polish)
    _validate(max_iter, n_ticks)
    T = int(n_ticks)
    Du = pp.Du
    if const_seq is not None and tuple(const_seq.shape) != (T, Du):
        raise ValueError(
            f"const_seq must be ({T}, {Du}), got {tuple(const_seq.shape)}")
    if not x0.is_cuda:
        return fused_rollout_plain(
            x0, carry, pp, rops, T, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            warmup_iters=warmup_iters, const_seq=const_seq, alpha=alpha,
            cone_ops=cone_ops,
        )

    nx, nu, N = pp.dims
    Dx = pp.Dx
    B = x0.shape[0]
    dev = x0.device
    x0 = _check("x0", x0, (B, nx), dev)
    D0 = _check("carry.D", carry.D, (B, Du), dev)
    Z0 = _check("carry.Z", carry.Z, (B, Du), dev)
    V0 = _check("carry.V", carry.V, (B, Dx), dev)
    tile, threads, smem, placement, ri = _geometry(
        pp, B, dev, batch_tile, threads, placement=placement,
        register_tile=register_tile)
    W_f, W_b, W_x, lo, hi = _kernel_operands(pp, dev)
    A = _check("rops.A", rops.A, (nx, nx), dev)
    Bm = _check("rops.B", rops.B, (nx, nu), dev)
    if const_seq is None:
        with torch.no_grad():
            cd = _check("const_d", fold_const_d(pp), (1, Du), dev)
    else:
        cd = _check("const_seq", const_seq, (T, Du), dev)
    cone_idx, cone_par, nc_u, nc_x, _alive = _cone_table(cone_ops, dev)

    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    us = new(T, B, nu)
    iters = torch.empty((T, B), dtype=torch.int32, device=dev)
    x_final = new(B, nx)
    U, X, D, Y, G, Z, V = (new(B, Du), new(B, Dx), new(B, Du), new(B, Du),
                           new(B, Dx), new(B, Du), new(B, Dx))
    stats = new(B, 6)
    adaptive = check_termination > 0
    counter = work_counter(dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.atm_fused_rollout(
            x0.data_ptr(), D0.data_ptr(), Z0.data_ptr(), V0.data_ptr(),
            W_f.data_ptr(), W_b.data_ptr(), W_x.data_ptr(), cd.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            us.data_ptr(), iters.data_ptr(), x_final.data_ptr(),
            U.data_ptr(), X.data_ptr(), D.data_ptr(), Y.data_ptr(),
            G.data_ptr(), Z.data_ptr(), V.data_ptr(), stats.data_ptr(),
            cone_idx, cone_par, nc_u, nc_x, counter.data_ptr(),
            B, nx, nu, N, T, 0 if const_seq is None else 1,
            int(max_iter), int(check_termination) if adaptive else 0,
            min(int(warmup_iters), int(max_iter) - 1) if adaptive else 0,
            float(pp.rho_f), float(alpha),
            float(abs_pri_tol), float(abs_dua_tol),
            tile, threads, smem, int(placement == "device"), ri, stream,
        )
    _raise_on(err, "fused_rollout")
    LAUNCH_COUNTS["fused_rollout" + ("" if adaptive else "_fixed")
                  + ("_cones" if cone_idx is not None else "")] += 1
    final = FusedResult(
        U=U, X=X, carry=FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), stats=stats)
    return RolloutResult(x_final=x_final, us=us, iters=iters, final=final)
