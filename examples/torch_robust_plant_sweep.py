"""Robust MPC under model uncertainty, PyTorch/CUDA port -- one *distinct
plant* per instance.

The port's counterpart of ``examples/robust_plant_sweep.py``, with its
arguments, printed lines and final check. The reference binds exactly one
plant per build (reference: src/tinympc/tiny_wrapper.hpp:6, codegen.cpp:
254-292 bake a single A/B); this example samples hundreds of perturbed
quadrotor models, builds every Riccati cache on the card (the fixed-point
kernel K5 through ``pad_hetero_from_plants``), solves all scenarios' MPC
problems in one hetero kernel launch a tick (K7), and takes the consensus
control. The closed loop then runs on a "true" plant the controller never
saw exactly. ``--cpu`` runs the plain versions.

Run: python examples/torch_robust_plant_sweep.py [--scenarios 256]
     [--ticks 80] [--iters 50] [--spread 0.03] [--cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.ops import (
    HeteroCarry,
    hetero_solve,
    pad_hetero_from_plants,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=80)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--spread", type=float, default=0.03,
                    help="multiplicative plant perturbation scale")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(device=device)
    nx, nu = problem.nx, problem.nu
    S = args.scenarios
    rng = np.random.default_rng(0)

    # Perturbed plant family: element-wise multiplicative noise on the
    # nominal dynamics (scenario 0 is the nominal plant itself).
    A0 = problem.A.double().cpu().numpy()
    B0 = problem.B.double().cpu().numpy()
    mulA = 1.0 + args.spread * rng.standard_normal((S, nx, nx))
    mulB = 1.0 + args.spread * rng.standard_normal((S, nx, nu))
    mulA[0] = 1.0
    mulB[0] = 1.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    As = f32(A0[None] * mulA)
    Bs = f32(B0[None] * mulB)
    Qs = problem.Q.expand(S, nx).contiguous()
    Rs = problem.R.expand(S, nu).contiguous()
    rhos = cache.rho.reshape(()).expand(S).to(torch.float32).contiguous()
    prob_b = problem.replace(**{
        k: a.expand((S,) + tuple(a.shape)).contiguous()
        for k, a in problem.tensors().items()})

    # On-device build: S Riccati fixed points + operand packing.
    sync = torch.cuda.synchronize if As.is_cuda else (lambda: None)
    t0 = time.time()
    hp, _caches = pad_hetero_from_plants(As, Bs, Qs, Rs, rhos, prob_b)
    sync()
    print(f"{S} on-device cache builds: {time.time() - t0:.2f}s")

    carry = HeteroCarry.zeros(hp)

    def tick(carry, x):
        # All scenarios share the measured state; duals reset per tick as in
        # the reference hover loop (quadrotor_hovering.cpp:88-90).
        x0s = x.expand(S, nx).contiguous()
        res = hetero_solve(x0s, carry.reset_duals(), hp, max_iter=args.iters)
        u = res.U[:, 0, :].mean(dim=0)      # consensus control
        spread = (res.U[:, 0, :] - u).abs().max()
        return res.carry, u, spread

    # "True" plant: a fresh perturbation outside the sampled family.
    true_mulA = 1.0 + args.spread * rng.standard_normal((nx, nx))
    true_mulB = 1.0 + args.spread * rng.standard_normal((nx, nu))
    At = f32(A0 * true_mulA)
    Bt = f32(B0 * true_mulB)

    x = f32(x0)
    t0 = time.time()
    for k in range(args.ticks):
        carry, u, spread = tick(carry, x)
        x = At @ x + Bt @ u
        if k % 5 == 0 or k == args.ticks - 1:
            err = float(torch.linalg.norm(x - problem.Xref[1]))
            print(f"tick {k:3d}  |x - xref| = {err:.4f}   "
                  f"u0 scenario spread = {float(spread):.4f}")
    wall = time.time() - t0
    err = float(torch.linalg.norm(x - problem.Xref[1]))
    print(f"\nfinal tracking error on the unseen true plant: {err:.4f}")
    print(f"{args.ticks} ticks x {S} scenarios in {wall:.2f}s "
          f"({args.ticks * S / wall:.0f} scenario-solves/s)")
    assert err < 0.1, "robust loop failed to stabilize the unseen plant"
    print("OK")


if __name__ == "__main__":
    main()
