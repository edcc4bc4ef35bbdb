"""Batched scenario MPC, PyTorch/CUDA port: thousands of perturbed
quadrotor instances through the full receding-horizon loop at once, one
shared plant (no reference counterpart; the reference is
one-problem-per-MCU).

The port's counterpart of ``examples/batch_scenario_mpc.py``, with its
arguments and printed lines. ``--tier auto`` runs the fused CUDA kernel on
the card (``api.fused_mpc_rollout``: one K1 launch a tick) and the scan
tier with ``--cpu``; ``--tier fused --cpu`` runs the fused tier's plain
version.

Run: python examples/torch_batch_scenario_mpc.py [--batch 4096]
     [--ticks 20] [--iters 100] [--tier auto|fused|scan] [--cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.api import fused_mpc_rollout, mpc_rollout
from accelerated_tinympc_tpu_torch.ops import pad_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--tier", default="auto",
                    choices=("auto", "fused", "scan"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(device=device)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        x0[None] + 0.05 * rng.standard_normal((args.batch, 12)),
        dtype=torch.float32, device=device)
    tier = args.tier if args.tier != "auto" else (
        "scan" if args.cpu else "fused")
    settings = atm.Settings(max_iter=args.iters, check_termination=0)

    if tier == "fused":
        ops = atm.condensed_operators(cache, problem.A, problem.B,
                                      problem.horizon, device=device)
        pp = pad_problem(problem, cache, ops, device=device)

        def run(x0s):
            xf, us, _carry = fused_mpc_rollout(
                pp, x0s, args.ticks, problem=problem, max_iter=args.iters)
            return xf, us
    else:
        def run(x0s):
            _, xf, trace = mpc_rollout(
                problem, cache, settings, x0s, args.ticks, batched=True)
            return xf, trace.u

    sync = torch.cuda.synchronize if x0s.is_cuda else (lambda: None)
    xf, us = run(x0s)
    sync()
    t0 = time.perf_counter()
    xf, us = run(x0s)
    sync()
    dt = time.perf_counter() - t0
    solves = args.batch * args.ticks
    err = torch.linalg.norm(xf - problem.Xref[0], dim=-1)
    print(f"tier={tier} batch={args.batch} ticks={args.ticks} "
          f"iters={args.iters}")
    print(f"{solves:,} solves in {dt*1e3:.1f} ms -> {solves/dt:,.0f} solves/s")
    print(f"tracking error after {args.ticks} ticks: "
          f"mean {float(err.mean()):.4f}, max {float(err.max()):.4f}")


if __name__ == "__main__":
    main()
