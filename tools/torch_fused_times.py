#!/usr/bin/env python3
"""Times of the fused kernels (K1-K4) of one checkout of the port on one GPU.

    python3 tools/torch_fused_times.py [ROOT] [--reps 3]

ROOT is the directory that holds ``accelerated_tinympc_tpu_torch`` (default:
this checkout), so the same script times an unpacked earlier commit beside
this one: run it on both in one call, in turns (parent, change, change,
parent), and compare only within that call. Each checkout builds its kernels
into a directory of its own under the system's temporary directory. The
workloads are this checkout's ``chip_smoke.py`` builders, built against
ROOT's package.

Prints one JSON line: K1 fixed-100 cold, K2 warm adaptive (check 1, tol
1e-3, after a 12-tick mission) and K3 (70 ticks adaptive) on the quadrotor
(nx=12, nu=4, N=10) at batch 65,536, and K4 a/b/c on the powered-descent
lander with both cones (nx=6, nu=3, N=15) at the same batch, as
``chip_smoke.py`` runs them; CUDA events after a warm-up. Beside K1 and
K4 a, the same fixed solves at 10 iterations (``*_it10_ms``): the two
lengths split a fixed solve's time into a part per solve (loads, results,
refills) and a part per iteration. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's workloads and timer

    sys.path.insert(0, str(root))
    tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
    os.environ["ATM_TORCH_BUILD_DIR"] = str(
        pathlib.Path(tempfile.gettempdir()) / f"atm_fused_times_{tag}")

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_rollout, fused_solve, pad_cones, rollout_ops,
    )

    assert pathlib.Path(atm.__file__).resolve().is_relative_to(root)
    ms = lambda fn, reps=args.reps: cs.cuda_ms(fn, reps)

    B, dev = cs.MAIN_BATCH, "cuda"
    problem, _cache, pp, x0s = cs.flagship(B, dev)
    rops = rollout_ops(problem, pp, device=dev)
    cold = FusedCarry.zeros(B, pp, device=dev)
    x1, warm = cs.warm_start(problem, pp, x0s, dev)
    kw = cs.WARM_KW
    row = {"root": str(root),
           "K1_ms": ms(lambda: fused_solve(x0s, cold, pp, max_iter=100)),
           "K1_it10_ms": ms(lambda: fused_solve(x0s, cold, pp, max_iter=10)),
           "K2_ms": ms(lambda: fused_solve(x1, warm, pp, **kw)),
           "K2_iters_mean": float(
               fused_solve(x1, warm, pp, **kw).stats[:, 0].mean()),
           "K3_ms": ms(
               lambda: fused_rollout(x0s, cold, pp, rops, 70, **kw), reps=1)}

    lproblem, _lcache, lpp, lx = cs.lander(B, dev)
    lcold = FusedCarry.zeros(B, lpp, device=dev)
    cops = pad_cones(lpp, cs.lander_cones())
    lrops = rollout_ops(lproblem, lpp, device=dev)
    k4a = lambda n: lambda: fused_solve(
        lx, lcold, lpp, cone_ops=cops, **{**cs.LANDER_FIXED, "max_iter": n})
    row["K4a_ms"] = ms(k4a(100))
    row["K4a_it10_ms"] = ms(k4a(10))
    row["K4b_ms"] = ms(lambda: fused_solve(
        lx, lcold, lpp, cone_ops=cops, **cs.LANDER_ADAPTIVE))
    row["K4b_iters_mean"] = float(fused_solve(
        lx, lcold, lpp, cone_ops=cops, **cs.LANDER_ADAPTIVE).stats[:, 0].mean())
    row["K4c_ms"] = ms(lambda: fused_rollout(
        lx, lcold, lpp, lrops, 30, cone_ops=cops, **cs.LANDER_MISSION),
        reps=1)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
