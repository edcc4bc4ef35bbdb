#!/usr/bin/env python3
"""Whether two checkouts' float32 fused kernels (K1-K4) give the same bits,
on one GPU.

    python3 tools/torch_fused_bits.py ROOT_A [ROOT_B]

Each ROOT holds ``accelerated_tinympc_tpu_torch`` (ROOT_B defaults to this
checkout), so an unpacked earlier commit can be held to this one. Each
checkout builds its kernels into a directory of its own (the two builds run
together) and runs in a process of its own, on the same inputs, this
checkout's ``chip_smoke.py`` workloads at batch 4,099 and one launch
geometry (the float32 kernels' own choice): K1 quadrotor fixed-100 cold, K2
warm (check 1, tolerance 1e-3), K3 a 12-tick adaptive mission, K4 a/b on
the lander with its two cones (fixed-100; check 2, tolerance 1e-2) and K4 c
a 10-tick coned mission. Prints one JSON line: per run and output field
whether the two agree bit for bit and their largest difference. Needs a
CUDA device and nvcc.
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

BUILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
from accelerated_tinympc_tpu_torch.ops import _build
_build.build_all()
'''

RUN = r'''
import importlib.util, sys, torch
root, here, out = sys.argv[1:4]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              here + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from accelerated_tinympc_tpu_torch.ops import (
    FusedCarry, fused_rollout, fused_solve, pad_cones, rollout_ops)
B, dev = 4099, "cuda"
solve = lambda r: [t.cpu() for t in (r.U, r.X, r.stats) + tuple(r.carry)]
mission = lambda r: [t.cpu() for t in (r.x_final, r.us, r.iters)] + solve(
    r.final)
res = {}
problem, _c, pp, x0s = cs.flagship(B, dev)
cold = FusedCarry.zeros(B, pp, device=dev)
res["K1 fixed-100 cold"] = solve(fused_solve(x0s, cold, pp, max_iter=100))
x1, warm = cs.warm_start(problem, pp, x0s, dev)
res["K2 warm check=1"] = solve(fused_solve(x1, warm, pp, **cs.WARM_KW))
res["K3 12 ticks"] = mission(fused_rollout(
    x0s, cold, pp, rollout_ops(problem, pp, device=dev), 12, **cs.WARM_KW))
lproblem, _lc, lpp, lx0 = cs.lander(B, dev)
lcold = FusedCarry.zeros(B, lpp, device=dev)
cops = pad_cones(lpp, cs.lander_cones())
res["K4a"] = solve(fused_solve(lx0, lcold, lpp, cone_ops=cops,
                               **cs.LANDER_FIXED))
res["K4b"] = solve(fused_solve(lx0, lcold, lpp, cone_ops=cops,
                               **cs.LANDER_ADAPTIVE))
res["K4c 10 ticks"] = mission(fused_rollout(
    lx0, lcold, lpp, rollout_ops(lproblem, lpp, device=dev), 10,
    cone_ops=cops, **cs.LANDER_MISSION))
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
    roots = [pathlib.Path(r).resolve() for r in (args.root_a, args.root_b)]
    tmps = [pathlib.Path(tempfile.mkdtemp(prefix="atm_fused_bits_"))
            for _ in roots]
    envs = [dict(os.environ, ATM_TORCH_BUILD_DIR=str(t / "build"))
            for t in tmps]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, str(r)], env=e,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r, e in zip(roots, envs)]
    for root, proc in zip(roots, builds):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{root}: build failed\n{log[-3000:]}")
    results = []
    for root, tmp, env in zip(roots, tmps, envs):
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(root), str(HERE),
             str(tmp / "res.pt")], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{root}: {proc.stderr[-3000:]}")
        results.append(torch.load(tmp / "res.pt"))
    solve = ("U", "X", "stats", "D", "Y", "G", "Z", "V")
    names = {k: (("x_final", "us", "iters") + solve if len(v) > 8 else solve)
             for k, v in results[0].items()}
    row = {"roots": [str(r) for r in roots], "runs": {}}
    for run, fields in names.items():
        row["runs"][run] = {
            f: {"bit_exact": bool(torch.equal(a, b)),
                "max_abs_diff": float((a.double() - b.double()).abs().max())}
            for f, a, b in zip(fields, results[0][run], results[1][run])}
    row["all_bit_exact"] = all(v["bit_exact"] for r in row["runs"].values()
                               for v in r.values())
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
