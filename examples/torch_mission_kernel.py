"""Receding-horizon missions at kernel speed, PyTorch/CUDA port: the ENTIRE
K-tick MPC loop -- dual reset, warm-started adaptive solve, pre-projection
u0 applied to the plant -- runs inside ONE CUDA kernel launch (K3,
``ops/fused_rollout.py``).

The port's counterpart of ``examples/mission_kernel.py``, with its
arguments and printed lines. The reference runs this loop on the host, one
tiny_solve per tick (reference: examples/quadrotor_hovering.cpp:90-114);
here the tick loop is in the kernel, so the warm-start carry never leaves
the card between ticks. ``--cpu`` runs the kernel's plain version
(``fused_rollout_plain``) at a batch of at most 8.

Run: python examples/torch_mission_kernel.py [--batch 4096] [--ticks 70]
     [--check 10] [--track] [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.ops import (
    FusedCarry, fused_rollout, pad_problem, rollout_const_seq, rollout_ops,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=70)
    ap.add_argument("--check", type=int, default=10,
                    help="termination-check cadence (0 = fixed 100 iters; "
                         "10 suits cold missions, 1 warm steady-state)")
    ap.add_argument("--track", action="store_true",
                    help="track the 20 Hz y-axis-line trajectory instead of "
                         "hovering (per-tick reference window streamed "
                         "in-kernel)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel's plain version)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    if args.track:
        problem, cache, x0, Xref_total = atm.models.quadrotor_tracking_setup(
            device=device)
        Xref_total = torch.as_tensor(Xref_total, dtype=torch.float32,
                                     device=device)
        ticks = min(args.ticks, Xref_total.shape[0] - problem.horizon - 1)
    else:
        problem, cache, x0 = atm.models.quadrotor_hovering_setup(
            device=device)
        Xref_total, ticks = None, args.ticks

    ops = atm.condensed_operators(cache, problem.A, problem.B,
                                  problem.horizon, device=device)
    pp = pad_problem(problem, cache, ops, device=device)
    rops = rollout_ops(problem, pp, device=device)
    const_seq = None
    if Xref_total is not None:
        const_seq = rollout_const_seq(
            pp, problem.Q, cache.Pinf, Xref_total, ticks)

    rng = np.random.default_rng(0)
    B = args.batch if not args.cpu else min(args.batch, 8)
    x0s = torch.as_tensor(
        x0[None] + 0.05 * rng.standard_normal((B, 12)),
        dtype=torch.float32, device=device)

    res = fused_rollout(
        x0s, FusedCarry.zeros(B, pp, device=device), pp, rops, ticks,
        max_iter=100, check_termination=args.check, abs_pri_tol=1e-3,
        abs_dua_tol=1e-3, const_seq=const_seq,
    )

    it = res.iters.double().cpu().numpy()
    ref = Xref_total[ticks] if Xref_total is not None else problem.Xref[0]
    err = torch.linalg.norm(res.x_final - ref[None], dim=-1).cpu().numpy()
    print(f"{ticks}-tick mission, batch {B}, one kernel launch "
          f"({'tracking' if args.track else 'hovering'}):")
    print(f"  iterations/tick: first {it[0].mean():.1f}, "
          f"last {it[-1].mean():.2f}, total mean {it.mean():.2f}")
    print(f"  final tracking error: mean {err.mean():.4f}, "
          f"max {err.max():.4f}")
    print(f"  u0 trace shape {tuple(res.us.shape)}; warm carry returned "
          "for mission continuation")

    # continue the mission 10 more ticks from the returned warm state
    if Xref_total is None:
        res2 = fused_rollout(
            res.x_final, res.final.carry, pp, rops, 10, max_iter=100,
            check_termination=max(args.check, 1), abs_pri_tol=1e-3,
            abs_dua_tol=1e-3,
        )
        per_tick = res2.iters.double().mean(dim=-1).cpu().numpy()
        print(f"  +10 warm ticks: iterations/tick "
              f"{per_tick.round(2).tolist()}")


if __name__ == "__main__":
    main()
