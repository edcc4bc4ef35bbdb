"""Quadrotor hovering MPC, PyTorch/CUDA port (capability parity with
reference: examples/quadrotor_hovering.cpp): 12-state Crazyflie-style LTI at
20 Hz, box-bounded inputs/states, hover setpoint z=2, 70 receding-horizon
ticks.

The port's counterpart of ``examples/quadrotor_hovering.py``, with its
arguments and printed lines. On the card each tick's solve is one launch of
the fused kernel (K1; K2 with ``--adaptive``); with ``--cpu`` the scan tier
runs the reference loop (``api.mpc_rollout``).

Run: python examples/torch_quadrotor_hovering.py [--ticks 70] [--hz 20]
     [--adaptive] [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.api import mpc_rollout


def fused_ticks(problem, cache, settings, x0, ticks, device):
    """The reference tick loop on the fused kernel: dual reset, warm
    slacks, the pre-projection u0 applied. Returns the plant states
    ``(ticks, nx)``, the final state and the iterations per tick."""
    from accelerated_tinympc_tpu_torch.ops import (
        FusedCarry, fused_solve, pad_problem, unpad_controls,
    )

    ops = atm.condensed_operators(cache, problem.A, problem.B,
                                  problem.horizon, device=device)
    pp = pad_problem(problem, cache, ops, device=device)
    x = x0[None]
    carry = FusedCarry.zeros(1, pp, device=device)
    xs, iters = [], []
    for _ in range(ticks):
        res = fused_solve(x, carry.reset_duals(), pp,
                          max_iter=settings.max_iter,
                          check_termination=settings.check_termination)
        carry = res.carry
        xs.append(x[0])
        iters.append(res.stats[0, 0])
        x = x @ problem.A.T + unpad_controls(res, pp) @ problem.B.T
    return torch.stack(xs), x[0], torch.stack(iters)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=70)
    ap.add_argument("--hz", type=int, default=20, choices=(20, 50, 100))
    ap.add_argument("--adaptive", action="store_true",
                    help="reference default settings (tol 1e-3, check every "
                         "iter) instead of fixed 100 iterations")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (scan tier)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(
        args.hz, device=device)
    settings = (
        atm.Settings(max_iter=100, check_termination=1)
        if args.adaptive
        else atm.Settings(max_iter=100, check_termination=0)
    )
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    if args.cpu:
        _, x_final, trace = mpc_rollout(problem, cache, settings, x0,
                                        args.ticks)
        xs, iters = trace.x, trace.iters
    else:
        xs, x_final, iters = fused_ticks(problem, cache, settings, x0,
                                         args.ticks, device)

    # Per-tick tracking error, as the reference example prints
    # (quadrotor_hovering.cpp:92).
    err = torch.linalg.norm(xs - problem.Xref[None, 0], dim=-1).cpu()
    for k in range(0, args.ticks, max(1, args.ticks // 20)):
        print(f"tick {k:3d}  tracking error: {float(err[k]):.6f}  "
              f"iters: {int(iters[k])}")
    final = float(torch.linalg.norm(x_final - problem.Xref[0]))
    print(f"final error: {final:.6f}")


if __name__ == "__main__":
    main()
