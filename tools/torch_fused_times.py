#!/usr/bin/env python3
"""Times of the fused kernels (K1-K4) of one checkout of the port on one GPU.

    python3 tools/torch_fused_times.py [ROOT] [--reps 3] [--algo bf16x3]

ROOT is the directory that holds ``accelerated_tinympc_tpu_torch`` (default:
this checkout), so the same script times an unpacked earlier commit beside
this one: run it on both in one call, in turns (parent, change, change,
parent), and compare only within that call. Each checkout builds its kernels
into a directory of its own under the system's temporary directory (the one
``torch_fused_bits.py`` builds into). The workloads are this checkout's
``chip_smoke.py`` workload functions, built against ROOT's package.

Prints one JSON line: K1 fixed-100 cold, K2 warm adaptive (check 1, tol
1e-3, after a 12-tick mission) and K3 (70 ticks adaptive) on the quadrotor
(nx=12, nu=4, N=10) at batch 65,536, and K4 a/b/c on the powered-descent
lander with both cones (nx=6, nu=3, N=15) at the same batch, as
``chip_smoke.py`` runs them; CUDA events after a warm-up. Beside each K4
row its box-only twin (``K4*_box_ms``: the same schedule without the
cones). Beside K1 and K4 a, the same fixed solves at 10 iterations
(``*_it10_ms``): the two lengths split a fixed solve's time into a part
per solve (loads, results, refills) and a part per iteration; K1 also
with its operators read from device memory at the slots a block of the
default placement (``K1_device_ms``: the same geometry and bits). K1's
fixed-100 cold solve also at other shapes: the quadrotor at 4,099
instances (``K1_b4099_ms``) and at one (``K1_b1_ms``, a single solve's
latency), and at horizons 40 and 129 at 4,099 (``K1_N40_ms``,
``K1_N129_ms``; the lander's box-only fixed solve is ``K4a_box_ms``), with
the path each takes where ROOT's wrapper names one (``K1_paths``,
``fused_admm.fixed_path``).

``--algo bf16x3`` times the split-bf16 kernels instead, on
``chip_smoke.py``'s workloads of them (its ``bf16x3_path`` rows), each
beside its float32 twin on the same schedule (``*_f32_ms``) and with the
slots a block of each (``*_slots``): K1 fixed-100 cold at polish 8, K2 warm
at check 1 (no split iteration) and at checks every 5 (tolerance 0.05), K3
70 ticks at checks every 5 (tolerance 1e-2), K4 a/b/c as above (each with
its split box-only twin, ``K4*_box_ms``). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--algo", default="f32", choices=("f32", "bf16x3"))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "tools"))
    import chip_smoke as cs   # this checkout's workloads and timer
    from torch_fused_bits import build_dir

    sys.path.insert(0, str(root))
    os.environ["ATM_TORCH_BUILD_DIR"] = build_dir(root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_admm, fused_rollout, fused_solve, pad_cones,
        rollout_ops,
    )

    assert pathlib.Path(atm.__file__).resolve().is_relative_to(root)
    ms = lambda fn, reps=args.reps: cs.cuda_ms(fn, reps)
    if args.algo == "bf16x3":
        print(json.dumps(split_times(cs, root, ms)), flush=True)
        return

    B, dev = cs.MAIN_BATCH, "cuda"
    problem, _cache, pp, x0s = cs.flagship(B, dev)
    rops = rollout_ops(problem, pp, device=dev)
    cold = FusedCarry.zeros(B, pp, device=dev)
    x1, warm = cs.warm_start(problem, pp, x0s, dev)
    kw = cs.WARM_KW
    row = {"root": str(root),
           "K1_ms": ms(lambda: fused_solve(x0s, cold, pp, max_iter=100)),
           "K1_it10_ms": ms(lambda: fused_solve(x0s, cold, pp, max_iter=10)),
           "K1_device_ms": ms(lambda: fused_solve(
               x0s, cold, pp, max_iter=100, placement="device",
               batch_tile=fused_admm._geometry(pp.dims, B, dev, None,
                                               None)[0])),
           "K2_ms": ms(lambda: fused_solve(x1, warm, pp, **kw)),
           "K2_iters_mean": float(
               fused_solve(x1, warm, pp, **kw).stats[:, 0].mean()),
           "K3_ms": ms(
               lambda: fused_rollout(x0s, cold, pp, rops, 70, **kw), reps=1)}

    # K1 at other shapes: batches 4,099 and 1, horizons 40 and 129
    fixed_path = getattr(fused_admm, "fixed_path", None)
    paths = {}

    def path_of(dims, batch):
        tile, threads, _smem, _placement, ri = fused_admm._geometry(
            dims, batch, dev, None, None)
        return fixed_path(dims, tile, threads, ri)

    for key, batch, horizon, reps in (("K1_b4099", cs.KERNEL_BATCH, 10, 3),
                                      ("K1_b1", 1, 10, 20),
                                      ("K1_N40", cs.KERNEL_BATCH, 40, 3),
                                      ("K1_N129", cs.KERNEL_BATCH, 129, 1)):
        _p, _c, ppk, xk = cs.flagship(batch, dev, horizon=horizon)
        ck = FusedCarry.zeros(batch, ppk, device=dev)
        row[f"{key}_ms"] = ms(
            lambda: fused_solve(xk, ck, ppk, max_iter=100), reps=reps)
        if fixed_path is not None:
            paths[key] = path_of(ppk.dims, batch)
    lproblem, _lcache, lpp, lx = cs.lander(B, dev)
    lcold = FusedCarry.zeros(B, lpp, device=dev)
    cops = pad_cones(lpp, cs.lander_cones())
    lrops = rollout_ops(lproblem, lpp, device=dev)
    if fixed_path is not None:
        paths["K1"] = path_of(pp.dims, B)
        paths["K4a_box"] = path_of(lpp.dims, B)
        row["K1_paths"] = paths
    k4a = lambda n, c=cops: lambda: fused_solve(
        lx, lcold, lpp, cone_ops=c, **{**cs.LANDER_FIXED, "max_iter": n})
    k4b = lambda c=cops: lambda: fused_solve(
        lx, lcold, lpp, cone_ops=c, **cs.LANDER_ADAPTIVE)
    k4c = lambda c=cops: lambda: fused_rollout(
        lx, lcold, lpp, lrops, 30, cone_ops=c, **cs.LANDER_MISSION)
    # each K4 row beside its box-only twin (the same schedule, no cones)
    row["K4a_ms"] = ms(k4a(100))
    row["K4a_box_ms"] = ms(k4a(100, None))
    row["K4a_it10_ms"] = ms(k4a(10))
    row["K4b_ms"] = ms(k4b())
    row["K4b_box_ms"] = ms(k4b(None))
    row["K4b_iters_mean"] = float(k4b()().stats[:, 0].mean())
    row["K4b_box_iters_mean"] = float(k4b(None)().stats[:, 0].mean())
    row["K4c_ms"] = ms(k4c(), reps=1)
    row["K4c_box_ms"] = ms(k4c(None), reps=1)
    print(json.dumps(row), flush=True)


def split_times(cs, root, ms) -> dict:
    """The split kernels' times on ``chip_smoke.py``'s workloads of them,
    each beside its float32 twin, with each one's slots a block."""
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_admm, fused_rollout, fused_solve, pad_cones,
        rollout_ops,
    )

    B, dev = cs.MAIN_BATCH, "cuda"
    problem, _cache, pp, x0s = cs.flagship(B, dev)
    rops = rollout_ops(problem, pp, device=dev)
    cold = FusedCarry.zeros(B, pp, device=dev)
    x1, warm = cs.warm_start(problem, pp, x0s, dev)
    lproblem, _lcache, lpp, lx = cs.lander(B, dev)
    lcold = FusedCarry.zeros(B, lpp, device=dev)
    cops = pad_cones(lpp, cs.lander_cones())
    lrops = rollout_ops(lproblem, lpp, device=dev)
    p8 = dict(max_iter=100, check_termination=0, polish=8)
    work = {   # key: (run(**algo), schedule, dims, reps)
        "K1": (lambda **a: fused_solve(x0s, cold, pp, **p8, **a), p8,
               pp.dims, None),
        "K2": (lambda **a: fused_solve(x1, warm, pp, **cs.WARM_KW, **a),
               cs.WARM_KW, pp.dims, None),
        "K2_check5": (lambda **a: fused_solve(
            x1, warm, pp, **cs.BF16X3_ADAPTIVE, **a), cs.BF16X3_ADAPTIVE,
            pp.dims, None),
        "K3": (lambda **a: fused_rollout(
            x0s, cold, pp, rops, 70, **cs.BF16X3_MISSION, **a),
            cs.BF16X3_MISSION, pp.dims, 1),
        "K4a": (lambda c=cops, **a: fused_solve(
            lx, lcold, lpp, cone_ops=c, **cs.LANDER_FIXED, **a),
            cs.LANDER_FIXED, lpp.dims, None),
        "K4b": (lambda c=cops, **a: fused_solve(
            lx, lcold, lpp, cone_ops=c, **cs.LANDER_ADAPTIVE, **a),
            cs.LANDER_ADAPTIVE, lpp.dims, None),
        "K4c": (lambda c=cops, **a: fused_rollout(
            lx, lcold, lpp, lrops, 30, cone_ops=c, **cs.LANDER_MISSION,
            **a), cs.LANDER_MISSION, lpp.dims, 1),
    }
    row = {"root": str(root), "algo": "bf16x3"}
    for key, (run, sched, dims, reps) in work.items():
        kw = {} if reps is None else {"reps": reps}
        skw = {k: v for k, v in sched.items() if k in (
            "max_iter", "check_termination", "warmup_iters", "polish")}
        splits = fused_admm.schedule_splits("bf16x3", **skw)
        row[f"{key}_f32_ms"] = ms(lambda: run(), **kw)
        row[f"{key}_ms"] = ms(lambda: run(algo="bf16x3"), **kw)
        row[f"{key}_slots"] = fused_admm._geometry(
            dims, B, dev, None, None, split=splits)[0]
        row[f"{key}_f32_slots"] = fused_admm._geometry(
            dims, B, dev, None, None)[0]
        if key.startswith("K4"):   # the box-only twin: no cones
            row[f"{key}_box_ms"] = ms(lambda: run(None, algo="bf16x3"),
                                      **kw)
    return row


if __name__ == "__main__":
    main()
