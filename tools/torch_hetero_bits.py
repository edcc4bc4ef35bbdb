#!/usr/bin/env python3
"""Whether two checkouts' fleet kernels (K7/K8) give the same bits, on one
GPU.

    python3 tools/torch_hetero_bits.py ROOT_A [ROOT_B]

Each ROOT holds ``accelerated_tinympc_tpu_torch`` (ROOT_B defaults to this
checkout), so an unpacked earlier commit can be held to this one. Each
checkout runs in a process of its own with its kernels built into a
directory of its own, on the same inputs: the robust sweep's family
(``tools/torch_stream_times.py``'s ``robust_family``, 4,099 instances,
caches from the batched tensor code) fixed 100 iterations and adaptive
(check 1, tolerance 1e-3), and ``examples/fleet_sweep.py``'s 8/3 family
with its cone, adaptive.
Prints one JSON line: per run and output field whether the two agree bit for
bit and their largest difference. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]

RUN = r'''
import sys, torch
root, here, out = sys.argv[1:4]
sys.path.insert(0, here + "/tools")
sys.path.insert(0, root)
import torch_stream_times as tst
import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha
kh8 = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
           abs_dua_tol=1e-3)
fields = lambda r: [t.cpu() for t in (r.U, r.X, r.stats) + tuple(r.carry)]
res = {}
fam = tst.robust_family(atm, 4099)
hp = ha.pad_hetero_from_plants(fam[0].A, fam[0].B, fam[0].Q, fam[0].R,
                               fam[1], fam[0], riccati="vmap")[0]
cold = ha.HeteroCarry.zeros(hp)
res["robust fixed-100"] = fields(ha.hetero_solve(fam[2], cold, hp,
                                                 max_iter=100))
res["robust check=1"] = fields(ha.hetero_solve(fam[2], cold, hp, **kh8))
fb = tst.fleet_family(atm, 4099)
hpb = ha.pad_hetero_from_plants(fb[0].A, fb[0].B, fb[0].Q, fb[0].R, fb[1],
                                fb[0], riccati="vmap")[0]
res["fleet_sweep 8/3 cone check=1"] = fields(ha.hetero_solve(
    fb[2], ha.HeteroCarry.zeros(hpb), hpb, **kh8, **fb[3]))
torch.save(res, out)
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b", nargs="?", default=str(HERE))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    results = []
    for root in (args.root_a, args.root_b):
        root = pathlib.Path(root).resolve()
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_hetero_bits_"))
        env = dict(os.environ, ATM_TORCH_BUILD_DIR=str(tmp / "build"))
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(root), str(HERE),
             str(tmp / "res.pt")], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{root}: {proc.stderr[-3000:]}")
        results.append(torch.load(tmp / "res.pt"))
    names = ("U", "X", "stats", "d", "y", "g", "z", "v")
    row = {"roots": [args.root_a, args.root_b],
           "device": torch.cuda.get_device_name(0)}
    for run in results[0]:
        row[run] = {
            n: {"bit_equal": bool(torch.equal(a, b)),
                "max_diff": float((a.double() - b.double()).abs().max())}
            for n, a, b in zip(names, results[0][run], results[1][run])}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
