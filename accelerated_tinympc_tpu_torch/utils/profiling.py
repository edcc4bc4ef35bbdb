"""Tracing, timing and cost models (the reference has only dead timing code
-- reference: src/tinympc/admm.cpp:10 -- and profiled in external tools;
here profiling is part of the package). Counterpart of the JAX package's
``utils/profiling.py``.

- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA activity
  when a card is present) and writes a Chrome trace under ``log_dir``.
- :func:`time_fn` measures steady-state time with warm-up: CUDA events on
  the current stream when the work runs on a card, ``perf_counter``
  otherwise.
- :func:`solver_cost`, :func:`hetero_cost`, :func:`stream_cost` are the JAX
  package's analytic models, value for value, so that the two packages'
  numbers compare. Their padded counts describe the TPU kernels' layouts
  (128 lanes, 8 sublanes), not the CUDA kernels'.
- :func:`solve_bound`, :func:`riccati_bound`, :func:`hetero_bound`,
  :func:`stream_bound` give the least time one H100 could take for each
  CUDA kernel's work on a given run's data (:data:`PEAK_FP32_FLOPS`,
  :data:`PEAK_BF16_FLOPS`, :data:`PEAK_BYTES_PER_S`): the larger of bytes
  over the memory rate (each input read once, each output written once)
  and the operations over the rate of their type (FP32; the fused
  kernels' split-bf16 products at the bf16 tensor rate,
  :func:`split_iters_of`).
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Any, Callable, Iterator

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, dense bf16 on the tensor cores (the fused kernels'
# algo="bf16x3" products), and HBM3 bandwidth. The other kernels are
# FP32-FMA work.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2) -> Iterator[Any]:
    """Profile the enclosed block with ``torch.profiler`` and write a Chrome
    trace ``trace_<pid>_<ns>.json`` under ``log_dir`` (viewable in
    Perfetto or ``chrome://tracing``). Records CUDA activity too when a card
    is present; kernels launched through the port's ``ctypes`` wrappers
    appear under their own names. ``host_tracer_level`` is the JAX
    signature's and, as there, unused. Yields the profiler
    (``key_averages()``, ``events()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _on_cuda(tree: Any) -> bool:
    """Whether any tensor in a (nested) result or argument list is on a
    CUDA device."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_on_cuda(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return any(_on_cuda(getattr(tree, k))
                   for k in tree.__dataclass_fields__)
    return False


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    reps: int = 5,
    warmup: int = 1,
) -> dict[str, float]:
    """Best/mean time of ``fn(*args)`` in seconds after ``warmup`` calls.
    When the arguments or the result lie on a card, each call is timed by
    CUDA events on the current stream; otherwise by ``perf_counter``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    cuda = _on_cuda(args) or _on_cuda(out)
    times = []
    if cuda:
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "reps": float(reps),
    }


# ------------------------------------------------- the JAX package's models --

def solver_cost(
    nx: int, nu: int, horizon: int, iters: int, *, lane_pad: int = 128
) -> dict[str, float]:
    """Analytic cost of one condensed-tier solve per instance, as the JAX
    package counts it.

    ``flops`` counts the unpadded math; ``flops_padded`` what the TPU's
    128-lane fused kernel issues (5 matmuls an iteration after hoisting, on
    operands padded to ``lane_pad``): a TPU layout, not the CUDA kernels'
    (:func:`solve_bound` counts those).
    """
    def pad(n: int) -> int:
        return ((n + lane_pad - 1) // lane_pad) * lane_pad

    Dx, Du = horizon * nx, (horizon - 1) * nu
    Dxp, Dup = pad(Dx), pad(Du)
    flops = 2 * iters * (Du * Dx + Du * Du + Dx * Du + Du * Du + Dx * Du)
    flops_padded = 2 * iters * (
        Dup * Dxp + Dup * Dup + Dxp * Dup + Dup * Dup + Dxp * Dup
    )
    state_bytes = 4 * (5 * Du + 4 * Dx)  # carries + in/out per solve
    return {
        "flops": float(flops),
        "flops_padded": float(flops_padded),
        "hbm_bytes_per_solve": float(state_bytes),
    }


def hetero_cost(
    nx: int, nu: int, horizon: int, iters: int, *, sublane_pad: int = 8
) -> dict[str, float]:
    """Analytic cost of one heterogeneous-tier solve per instance, as the
    JAX package counts it for its TPU kernel (knots on sublanes padded to
    ``sublane_pad``, instances on lanes, every matvec full-width vector
    multiply-adds).

    ``vpu_flops`` counts the padded per-lane FMAs that TPU kernel issues per
    instance: per knot the forward sweep runs K (SX->SU), A (SX->SX), B
    (SU->SX) and the backward sweep Bt (SX->SU), Quu (SU->SU), M (SX->SX),
    Kt (SU->SX) matvecs; ``vmem_resident_bytes`` its resident operands on
    128 lanes. ``vpu_flops_useful`` is the unpadded count
    (:func:`hetero_bound` counts the CUDA kernels' work)."""
    def pad(n: int) -> int:
        return ((n + sublane_pad - 1) // sublane_pad) * sublane_pad

    SX, SU = pad(nx), pad(nu)
    m = horizon - 1
    per_knot = 2 * (2 * SX * SX + 4 * SX * SU + SU * SU)
    vpu_flops = iters * m * per_knot
    useful = iters * m * 2 * (2 * nx * nx + 4 * nx * nu + nu * nu)
    return {
        "vpu_flops": float(vpu_flops),
        "vpu_flops_useful": float(useful),
        "vmem_resident_bytes": float(
            4 * (3 * SX * SX + 4 * SX * SU + SU * SU) * 128
        ),
    }


def stream_cost(
    nx: int, nu: int, horizon: int, iters: int, *, sublane_pad: int = 8
) -> dict[str, float]:
    """Analytic device-memory traffic of one streaming-tier solve per
    instance, as the JAX package counts it for its TPU kernel (rows padded
    to ``sublane_pad`` sublanes).

    Per iteration the streamed set is: forward reads ``d, y, g`` and writes
    ``y, g, z, v``; backward reads ``y, z, g, v, qc`` and writes ``d`` -- 7
    input-space and 6 state-space whole arrays (:func:`stream_bound`'s
    streamed time counts the same set unpadded)."""
    def pad(n: int) -> int:
        return ((n + sublane_pad - 1) // sublane_pad) * sublane_pad

    SX, SU = pad(nx), pad(nu)
    m = horizon - 1
    per_iter = 4 * (7 * m * SU + 6 * horizon * SX)
    return {
        "hbm_bytes_per_iter": float(per_iter),
        "hbm_bytes_per_solve": float(per_iter * iters),
    }


# ------------------------------------------------- the card's least times --

def solve_bound(dims, iters_total: float, n_solves: float, batch: int,
                ticks: int = 0, split_iters: float = 0.0):
    """Least time the card could take for the fused kernels (K1-K4): the
    larger of bytes / memory rate (each input read once, each output
    written once) and the operations' time. ``iters_total`` is the sum
    over instances (and ticks) of the iterations this run's data needed;
    ``n_solves`` counts the hoisted x0 products; ``ticks`` > 0 for a
    mission. ``split_iters`` of the ``iters_total`` iterations ran
    ``algo="bf16x3"``'s split products: each of their two products is three
    bf16 passes at :data:`PEAK_BF16_FLOPS`; the other iterations' products,
    the x0 products and the plant steps count at :data:`PEAK_FP32_FLOPS`,
    and the operations' time is the sum of the two. Returns ``(ms,
    "operations" or "bytes")``."""
    nx, nu, N = dims
    Dx, Du = N * nx, (N - 1) * nu
    per_iter = 2 * (Du * Dx + Du * Du + Dx * Du + Du * Du)
    flops = (iters_total - split_iters) * per_iter
    flops += n_solves * 2 * nx * (Dx + Du)
    flops += n_solves * 2 * nx * (nx + nu) if ticks else 0
    carry_in = nx + 3 * Du + 2 * Dx if not ticks else nx + 2 * Du + Dx
    out = 4 * Du + 3 * Dx + 6 + (ticks * (nu + 1) + nx if ticks else 0)
    operators = 2 * Du * (Dx + Du) + nx * (Dx + Du) + 2 * (Dx + Du) + Du
    nbytes = 4 * (batch * (carry_in + out) + operators + ticks * Du)
    t_ops = (flops / PEAK_FP32_FLOPS
             + 3 * split_iters * per_iter / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def split_iters_of(iters, *, max_iter: int, check_termination: int = 0,
                   warmup_iters: int = 0, polish: int = 8) -> float:
    """How many of the iterations that solves ran were split ones under
    ``algo="bf16x3"``'s schedule: ``iters`` holds each solve's iteration
    count (a tensor or array: per instance, or per instance and tick), the
    schedule keywords are the solves' (the iterations that
    :func:`..ops.fused_admm.split_iteration` names)."""
    import numpy as np

    from ..ops.fused_admm import split_iteration

    counts = np.asarray(iters.cpu() if hasattr(iters, "cpu") else iters,
                        np.int64).ravel()
    split = [split_iteration(it, algo="bf16x3", max_iter=max_iter,
                             check_termination=check_termination,
                             warmup_iters=warmup_iters, polish=polish)
             for it in range(1, max_iter + 1)]
    split_before = np.concatenate([[0], np.cumsum(split)])   # in 1..count
    return float(split_before[np.clip(counts, 0, max_iter)].sum())


def riccati_bound(nx, nu, steps_total: float, batch: int, inner: int = 0,
                  warm: bool = False):
    """Least time for the Riccati kernels (K5/K6): ``steps_total`` is the
    sum over instances of the steps this run's data needed (fixed-point
    steps, or Newton outer steps of ``inner`` doublings each); the cache
    terms cost about one more gain update per instance. Returns ``(ms,
    "operations" or "bytes")``."""
    gain = 2 * nu * nx * nx + nu * nu * nx + nu ** 3 // 3 + nu * nu * nx
    if inner:
        step = 2 * nx * nu * nx + inner * 3 * nx ** 3 + gain
    else:
        step = gain + nx * nu * nx + 2 * nx ** 3
    flops = 2 * (steps_total * step + batch * (gain + 2 * nx * nx * nu))
    words_in = nx * nx + nx * nu + nx + nu + 1
    words_in += (nx * nx + nu * nx) if warm else (nu * nx if inner else 0)
    words_out = nu * nx + 2 * nx * nx + nu * nu + nx * nu + 1
    nbytes = 4 * batch * (words_in + words_out)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def hetero_bound(dims, iters_total: float, batch: int):
    """Least time for the hetero kernels (K7/K8): 2 m (2 nx nu + nx^2 + nu
    nx + nu^2 + nx^2 + nx nu) FLOP per instance-iteration (forward: Kinf, A,
    B; backward: B', Quu_inv, AmBKt, Kinf'), ``iters_total`` summed over the
    instances as this run's data needed; bytes: the per-instance operands,
    bounds, x0 and carry read once, outputs and carry written once. Returns
    ``(ms, "operations" or "bytes")``."""
    nx, nu, N = dims
    m = N - 1
    flops = iters_total * 2 * m * (2 * nx * nu + nx * nx + nu * nx + nu * nu
                                   + nx * nx + nx * nu)
    words_in = (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * m * nu
                + 3 * N * nx + 2 * nx + 1 + 3 * m * nu + 2 * N * nx)
    words_out = m * nu + N * nx + 3 * m * nu + 2 * N * nx + 8
    nbytes = 4 * batch * (words_in + words_out)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def stream_bound(dims, iters_total: float, batch: int, shared: bool):
    """Least time for the long-horizon kernels (K9-K12): 2 m (4 nx nu + 2
    nx^2 + nu^2) FLOP per instance-iteration (``iters_total`` summed over
    the instances as this run's data needed), bytes as for every row: x0,
    the carry, the plant and its cache (once when ``shared``, else per
    instance), qc, pterm, rho and uniform bounds read once, U, X, the carry
    and the stats written once. Also returned: the bound with the iterates
    streamed through device memory every iteration (forward: d, y, g read,
    y, z, g, v written; backward: y, z, g, v, qc read, d written; 7 m nu + 6
    N nx floats per instance-iteration), the least traffic of a design that
    cannot hold a batch's iterates on chip. Returns ``(ms, "operations" or
    "bytes", streamed ms)``."""
    nx, nu, N = dims
    m = N - 1
    flops = iters_total * 2 * m * (4 * nx * nu + 2 * nx * nx + nu * nu)
    plant = (2 * nx * nx + 2 * nx * nu + nu * nu + N * nx + nx + 1
             + 2 * nx + 2 * nu)
    words_in = batch * (nx + 3 * m * nu + 2 * N * nx) + (
        1 if shared else batch) * plant
    words_out = batch * (m * nu + N * nx + 3 * m * nu + 2 * N * nx + 8)
    t_ops = flops / PEAK_FP32_FLOPS
    t_bytes = 4 * (words_in + words_out) / PEAK_BYTES_PER_S
    t_stream = 4 * iters_total * (7 * m * nu + 6 * N * nx) / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_ops, t_stream))
