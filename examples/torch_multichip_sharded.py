"""Sharded batch solve over several GPUs, PyTorch/CUDA port (no reference
counterpart -- the reference has no distribution): a large batch of MPC
instances split over the ranks of a ``torch.distributed`` world, one
process per GPU. The solve needs no traffic; the convergence stats are
all-reduced.

The port's counterpart of ``examples/multichip_sharded.py``, with its
arguments and printed lines. A world of one by default; under ``torchrun``
each rank takes its block of the global batch:

  python examples/torch_multichip_sharded.py              # one GPU
  torchrun --nproc-per-node=N examples/torch_multichip_sharded.py
  torchrun --nproc-per-node=2 examples/torch_multichip_sharded.py --cpu

``--cpu`` runs CPU ranks over gloo (the plain versions); without it each
rank drives ``cuda:$LOCAL_RANK`` over NCCL.
"""

import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch
import torch.distributed as dist

import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.parallel import (
    initialize_distributed,
    make_batch_mesh,
    replicate,
    shard_batch,
    sharded_solve,
    summarize_stats,
)
from accelerated_tinympc_tpu_torch.solver.batched import init_state_batched


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks over gloo (the plain versions)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    env = os.environ
    if "WORLD_SIZE" in env:   # torchrun
        initialize_distributed(
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]), device=device)
    mesh = make_batch_mesh(device=device)
    batch = args.batch_per_device * mesh.size
    if mesh.rank == 0:
        print(f"{mesh.size} devices ({mesh.device.type}, "
              f"{mesh.backend or 'one process'}), batch {batch}")

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(device="cpu")
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        x0[None] + 0.05 * rng.standard_normal((batch, 12)),
        dtype=torch.float32)
    state = init_state_batched(batch, 12, 4, 10, device="cpu")
    x = state.x.clone()
    x[:, 0, :] = x0s
    state = state.replace(x=x)

    settings = atm.Settings(
        abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400, check_termination=1
    )
    solve = sharded_solve(mesh, settings)
    out, stats = solve(
        shard_batch(state, mesh), replicate(problem, mesh),
        replicate(cache, mesh),
    )
    b = out.u.shape[0]
    rows = f"rows [{mesh.rank * b}, {(mesh.rank + 1) * b})"
    if mesh.rank == 0:
        print(f"output shard: rank {mesh.rank} holds {rows} on {out.u.device}")
        for k, v in summarize_stats(stats).items():
            print(f"  {k}: {v:.4f}")
    if mesh.size > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
