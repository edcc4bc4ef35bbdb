#!/usr/bin/env python3
"""Where float32 stops telling Riccati steps apart, on one GPU.

    python3 tools/torch_riccati_floor.py [--batch 4099]

The quadrotor's plant (nx=12, nu=4) once per instance with rho spread over
1e-3..1e3. Prints the card's name and power limit, then (1) max|dK| of the
plain fixed point after 20..640 steps in float32 and in float64 for five of
the rho values: the float32 column stops falling at its rounding floor; (2)
for a sweep of tolerances, how often the Riccati kernels and their plain
versions take the same number of steps (equal, within one, worst, both
means), cold and warm fixed point and the Newton refresh. A tolerance near
the floor is decided by rounding, so the counts disagree there while the
means agree. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import accelerated_tinympc_tpu_torch as atm  # noqa: E402
from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk  # noqa: E402
from accelerated_tinympc_tpu_torch.precompute import (  # noqa: E402
    riccati_fixed_point, riccati_newton,
)


def agreement(kernel_steps, plain_steps):
    d = (kernel_steps - plain_steps).abs()
    return {"equal": float((d == 0).float().mean()),
            "within_one": float((d <= 1).float().mean()),
            "worst": int(d.max()),
            "mean_kernel": float(kernel_steps.float().mean()),
            "mean_plain": float(plain_steps.float().mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4099)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    prob = atm.models.quadrotor_hovering_setup()[0]
    wide = lambda a: a.expand((args.batch,) + tuple(a.shape)).contiguous()
    P = (wide(prob.A), wide(prob.B), wide(prob.Q), wide(prob.R),
         torch.logspace(-3, 3, args.batch, device="cuda"))

    pick = torch.linspace(0, args.batch - 1, 5, device="cuda").long()
    for dtype in (torch.float32, torch.float64):
        few = [a[pick].to(dtype) for a in P]
        rows = {}
        for steps in (20, 40, 80, 160, 320, 640):
            a = riccati_fixed_point(*few, max_iters=steps, tol=0.0)[0]
            b = riccati_fixed_point(*few, max_iters=steps + 1, tol=0.0)[0]
            rows[steps] = (b.Kinf - a.Kinf).abs().amax(dim=(-2, -1)).tolist()
        print(json.dumps({"dtype": str(dtype), "rho": P[4][pick].tolist(),
                          "max_dK_after_steps": rows}), flush=True)

    for tol in (1e-2, 3e-3, 1e-3, 3e-4, 1e-4, 1e-5):
        got, it_k = rk.riccati_fixed_point_kernel(*P, tol=tol)
        _, it_p = riccati_fixed_point(*P, max_iters=1000, tol=tol)
        out = {"tol": tol, "fixed_point_cold": agreement(it_k, it_p)}
        rho2 = P[4] * 5.0
        warm = dict(P0=got.Pinf, K0=got.Kinf)
        _, it_k = rk.riccati_fixed_point_kernel(*P[:4], rho2, tol=tol, **warm)
        _, it_p = riccati_fixed_point(*P[:4], rho2, max_iters=1000, tol=tol,
                                      **warm)
        out["fixed_point_warm"] = agreement(it_k, it_p)
        _, it_k = rk.riccati_newton_kernel(*P[:4], rho2, got.Kinf, tol=tol)
        _, it_p = riccati_newton(*P[:4], rho2, got.Kinf, tol=tol,
                                 max_outer=12, inner_iters=13)
        out["newton"] = agreement(it_k, it_p)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
