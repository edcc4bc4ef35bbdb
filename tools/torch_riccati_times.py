#!/usr/bin/env python3
"""Times of the Riccati kernels (K5, K6) of one checkout of the port on one
GPU.

    python3 tools/torch_riccati_times.py [ROOT] [--reps 3]

ROOT is the directory that holds ``accelerated_tinympc_tpu_torch`` (default:
this checkout), so the same script times an unpacked earlier commit beside
this one: run it on both in one call, in turns (parent, change, change,
parent), and compare only within that call. Each checkout builds its kernels
into a directory of its own under the system's temporary directory.

Prints one JSON line. The workloads are ``chip_smoke.py``'s: the
quadrotor's plant (nx=12, nu=4) once per instance with rho over 1e-3..1e3
at batch 65,536; K5 cold at its default tolerance 1e-5 (``K5_ms``, its mean
steps beside it), K6 refreshing that cache at five times the rho
(``K6_ms``). At tolerance 1e-5 the quadrotor's stopping step is float32
rounding noise (PERF.md), so two implementations stop at other steps; the
fixed-count runs split that off: K5 at tolerance 0 for exactly 100 steps
(``K5_100_steps_ms``) and K6 for exactly 2 outer steps of 13 doublings
(``K6_2_outer_ms``). Then ``TinyMPC.solve_adaptive_rho(riccati="kernel")``
on 65,536 quadrotors with mis-scaled rho, as ``chip_smoke.py``'s second
path runs it (``adaptive_rho_kernel_ms``, one call). Needs a CUDA device and
nvcc.
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
    import chip_smoke as cs   # this checkout's timer

    sys.path.insert(0, str(root))
    tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
    os.environ["ATM_TORCH_BUILD_DIR"] = str(
        pathlib.Path(tempfile.gettempdir()) / f"atm_riccati_times_{tag}")

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import accelerated_tinympc_tpu_torch as atm
    from accelerated_tinympc_tpu_torch.ops import riccati_kernel as rk

    assert pathlib.Path(atm.__file__).resolve().is_relative_to(root)
    ms = lambda fn: cs.cuda_ms(fn, args.reps)

    B, dev = cs.MAIN_BATCH, "cuda"
    prob = atm.models.quadrotor_hovering_setup(device=dev)[0]
    wide = lambda a: a.expand((B,) + tuple(a.shape)).contiguous()
    A, Bm, Q, R = wide(prob.A), wide(prob.B), wide(prob.Q), wide(prob.R)
    rho = torch.logspace(-3, 3, B, device=dev)
    cache, steps = rk.riccati_fixed_point_kernel(A, Bm, Q, R, rho)
    rho2 = rho * 5.0
    _, outer = rk.riccati_newton_kernel(A, Bm, Q, R, rho2, cache.Kinf)
    row = {
        "root": str(root),
        "K5_ms": ms(lambda: rk.riccati_fixed_point_kernel(A, Bm, Q, R, rho)),
        "K5_steps_mean": float(steps.float().mean()),
        "K5_at_cap_share": float((steps >= 1000).float().mean()),
        "K6_ms": ms(lambda: rk.riccati_newton_kernel(
            A, Bm, Q, R, rho2, cache.Kinf)),
        "K6_outer_mean": float(outer.float().mean()),
        "K5_100_steps_ms": ms(lambda: rk.riccati_fixed_point_kernel(
            A, Bm, Q, R, rho, max_iters=100, tol=0.0)),
        "K6_2_outer_ms": ms(lambda: rk.riccati_newton_kernel(
            A, Bm, Q, R, rho2, cache.Kinf, max_outer=2, tol=0.0)),
        "device": torch.cuda.get_device_name(0),
    }
    # End to end: per-instance adaptive rho through TinyMPC with K5
    # refreshes, as chip_smoke.py's second path runs it (one call).
    import numpy as np

    prob, cch, _x0 = atm.models.quadrotor_hovering_setup(device=dev)
    mpc = atm.TinyMPC.from_parts(
        prob, cch, batch=B, settings=atm.Settings(
            abs_pri_tol=1e-2, abs_dua_tol=1e-2, check_termination=1))
    rng = np.random.default_rng(0)
    mpc.set_x0(prob.Xref[0].cpu().numpy()[None]
               + 0.2 * rng.standard_normal((B, 12)))
    rho0 = float(cch.rho) * np.tile([1.0, 1e-3, 200.0], B // 3 + 1)[:B]
    _, row["adaptive_rho_kernel_ms"] = cs.timed(lambda: mpc.solve_adaptive_rho(
        riccati="kernel", rho0=rho0.astype(np.float32), max_rounds=12))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
