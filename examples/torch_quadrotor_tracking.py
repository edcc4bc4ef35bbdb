"""Quadrotor trajectory tracking, PyTorch/CUDA port (capability parity with
reference: examples/quadrotor_tracking.cpp): slide a 10-knot horizon window
along a 301-knot y-axis line trajectory at 20 Hz, one solve per tick.

The port's counterpart of ``examples/quadrotor_tracking.py``, with its
arguments and printed lines. On the card every tick is one launch of the
fused kernel (K1; K2 with ``--adaptive``), the window's reference operands
recomputed on the device each tick (``ops.fused_admm.ref_vectors``, the
slide of quadrotor_tracking.cpp:101); with ``--cpu`` the scan tier runs the
reference loop. ``--ticks`` cuts the run (default: the reference's
NTOTAL - NHORIZON - 1 = 290, quadrotor_tracking.cpp:93).

Run: python examples/torch_quadrotor_tracking.py [--adaptive] [--ticks T]
     [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.api import mpc_rollout, tracking_error


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trajectory", default="quadrotor_20hz_y_axis_line")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--ticks", type=int, default=0,
                    help="ticks to run (0: the reference's count)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (scan tier)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    problem, cache, x0, Xref_total = atm.models.quadrotor_tracking_setup(
        trajectory=args.trajectory, device=device)
    # reference runs NTOTAL - NHORIZON - 1 ticks (quadrotor_tracking.cpp:93)
    ticks = Xref_total.shape[0] - problem.horizon - 1
    if args.ticks:
        ticks = min(ticks, args.ticks)
    settings = (
        atm.Settings(max_iter=100, check_termination=1)
        if args.adaptive
        else atm.Settings(max_iter=25, check_termination=0)
    )

    Xref_dev = torch.as_tensor(Xref_total, dtype=torch.float32, device=device)
    x0_dev = torch.as_tensor(x0, dtype=torch.float32, device=device)
    if not args.cpu:
        # fused CUDA tier with the sliding window recomputed on the device
        from accelerated_tinympc_tpu_torch.api import fused_mpc_rollout
        from accelerated_tinympc_tpu_torch.ops import pad_problem

        ops = atm.condensed_operators(cache, problem.A, problem.B,
                                      problem.horizon, device=device)
        pp = pad_problem(problem, cache, ops, device=device)
        _xf, us, _ = fused_mpc_rollout(
            pp, x0_dev[None], ticks, problem=problem,
            max_iter=settings.max_iter,
            check_termination=settings.check_termination,
            Xref_total=Xref_dev, Pinf=cache.Pinf,
        )
        # reconstruct the plant trace for error reporting
        us = us[:, 0].double().cpu().numpy()
        A = problem.A.double().cpu().numpy()
        Bm = problem.B.double().cpu().numpy()
        xs = [np.asarray(x0, np.float64)]
        for k in range(ticks - 1):
            xs.append(A @ xs[-1] + Bm @ us[k])
        err = np.linalg.norm(np.stack(xs) - Xref_total[:ticks], axis=-1)
    else:
        _, _, trace = mpc_rollout(problem, cache, settings, x0_dev, ticks,
                                  Xref_total=Xref_dev)
        err = tracking_error(trace, Xref_dev).cpu().numpy()
    for k in range(0, ticks, max(1, ticks // 20)):
        print(f"tick {k:3d}  tracking error: {err[k]:.6f}")
    print(f"mean tracking error: {err.mean():.6f}  max: {err.max():.6f}")


if __name__ == "__main__":
    main()
