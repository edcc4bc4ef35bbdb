#!/usr/bin/env python3
"""Launch-geometry sweep of the port's fused CUDA kernels on one GPU.

    python3 tools/torch_kernel_sweep.py [--batch 65536] [--ticks 70]

Times the fixed-100 solve, an adaptive solve that checks every iteration and
never exits (tolerance 0: what a check costs), a warm adaptive solve and an
adaptive hovering mission (quadrotor, nx=12, nu=4, N=10) for every (slots per
block, threads per block) pair that fits shared memory, with CUDA events
after a warm-up, and prints one JSON line per pair. Before them come the
card's name and power limit, and one line on the warm solve's iteration
counts: their mean, and the mean over fixed groups of as many instances as a
block has slots (and over register-tile groups) of the slowest instance,
what a block of lockstep instances would wait for (the slot kernels do not).
Each pair's line also gives what a check costs (the never-exiting adaptive
solve over the fixed one) and the block-iterations the warm solve spends per
iteration its instances need (its time over the fixed solve's per-iteration
time, per mean iteration count: 1 would be perfect packing with free checks
and refills). The defaults the wrappers use (``ops/fused_admm.py``
MAX_THREADS, THREADS_PER_INSTANCE) were read off this table. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (the workloads and the timer)
from accelerated_tinympc_tpu_torch.ops import (  # noqa: E402
    FusedCarry, fused_admm, fused_rollout, fused_solve, rollout_ops,
)


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
    B = args.batch
    problem, _cache, pp, x0s = cs.flagship(B, "cuda")
    rops = rollout_ops(problem, pp, device="cuda")
    cold = FusedCarry.zeros(B, pp, device="cuda")
    adaptive = cs.WARM_KW
    x1, warm = cs.warm_start(problem, pp, x0s, "cuda")
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
                "fixed100_ms": cs.cuda_ms(lambda: fused_solve(
                    x0s, cold, pp, max_iter=100, **geo)),
                "adaptive_noexit_ms": cs.cuda_ms(lambda: fused_solve(
                    x0s, cold, pp, max_iter=100, check_termination=1,
                    abs_pri_tol=0.0, abs_dua_tol=0.0, **geo)),
                "adaptive_warm_ms": cs.cuda_ms(lambda: fused_solve(
                    x1, warm, pp, **adaptive, **geo)),
                "rollout_adaptive_ms": cs.cuda_ms(lambda: fused_rollout(
                    x0s, cold, pp, rops, args.ticks, **adaptive, **geo),
                    reps=1),
            }
            row["check_cost"] = row["adaptive_noexit_ms"] / row["fixed100_ms"]
            row["warm_block_iters_per_needed"] = (
                row["adaptive_warm_ms"] / row["fixed100_ms"] * 100
                / float(its.mean()))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
