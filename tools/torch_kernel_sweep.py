#!/usr/bin/env python3
"""Launch-geometry sweep of the port's fused CUDA kernels on one GPU.

    python3 tools/torch_kernel_sweep.py [--batch 65536] [--ticks 70]

Times the fixed-100 solve, an adaptive solve that checks every iteration and
never exits (tolerance 0: what a check costs), a warm adaptive solve and an
adaptive hovering mission (quadrotor, nx=12, nu=4, N=10) for every (instances
per block, threads per block) pair that fits shared memory, with CUDA events
after a warm-up, and prints one JSON line per pair. Before them come the
card's name and power limit, and one line on the warm solve's iteration
counts: their mean, and the mean over blocks (and over register-tile groups)
of the slowest instance, which is what a block (a group) waits for. The
defaults the wrappers use (``ops/fused_admm.py`` MAX_THREADS,
THREADS_PER_INSTANCE) were read off this table. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import accelerated_tinympc_tpu_torch as atm  # noqa: E402
from accelerated_tinympc_tpu_torch.ops import (  # noqa: E402
    FusedCarry, fused_admm, fused_rollout, fused_solve, pad_problem,
    rollout_ops,
)


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--ticks", type=int, default=70)
    ap.add_argument("--tiles", type=int, nargs="*", default=None)
    ap.add_argument("--threads", type=int, nargs="*",
                    default=[64, 128, 192, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    ops = atm.condensed_operators(cache, problem.A, problem.B, problem.horizon)
    pp = pad_problem(problem, cache, ops)
    rops = rollout_ops(problem, pp)
    B = args.batch
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(x0[None] + 0.05 * rng.standard_normal((B, 12)),
                          dtype=torch.float32, device="cuda")
    cold = FusedCarry.zeros(B, pp)
    adaptive = dict(max_iter=100, check_termination=1)
    lead = fused_rollout(x0s, cold, pp, rops, 12, **adaptive)
    x1, warm = lead.x_final, lead.final.carry.reset_duals()
    fit = fused_admm.choose_tile(pp.dims, 10 ** 9, 1)
    its = fused_solve(x1, warm, pp, **adaptive).stats[:, 0]
    tile0 = fused_admm.choose_tile(pp.dims, B)
    slowest = lambda n: float(
        its[: (B // n) * n].reshape(-1, n).max(dim=1).values.mean())
    print(json.dumps({
        "warm_iters_mean": float(its.mean()), "default_tile": tile0,
        "slowest_in_block_mean": slowest(tile0),
        "slowest_in_group_mean": slowest(fused_admm.REGISTER_TILE)}),
        flush=True)
    tiles = args.tiles or list(range(8, fit + 1, 8))
    for tile in tiles:
        if tile > fit:
            continue
        for threads in args.threads:
            if threads < tile:
                continue
            geo = dict(batch_tile=tile, threads=threads)
            row = {
                "tile": tile, "threads": threads,
                "smem_bytes": fused_admm.kernel_smem_bytes(*pp.dims, tile),
                "fixed100_ms": cuda_ms(lambda: fused_solve(
                    x0s, cold, pp, max_iter=100, **geo)),
                "adaptive_noexit_ms": cuda_ms(lambda: fused_solve(
                    x0s, cold, pp, max_iter=100, check_termination=1,
                    abs_pri_tol=0.0, abs_dua_tol=0.0, **geo)),
                "adaptive_warm_ms": cuda_ms(lambda: fused_solve(
                    x1, warm, pp, **adaptive, **geo)),
                "rollout_adaptive_ms": cuda_ms(lambda: fused_rollout(
                    x0s, cold, pp, rops, args.ticks, **adaptive, **geo),
                    reps=1),
            }
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
