#!/usr/bin/env python3
"""Whether two checkouts' fused kernels (K1-K4, float32 or split-bf16) give
the same bits, on one GPU.

    python3 tools/torch_fused_bits.py ROOT_A [ROOT_B] [--algo f32|bf16x3]

Each ROOT holds ``accelerated_tinympc_tpu_torch`` (ROOT_B defaults to this
checkout), so an unpacked earlier commit can be held to this one. Each
checkout builds its kernels into a directory of its own under the system's
temporary directory (the two builds run together; ``torch_fused_times.py``
reuses them) and runs in a process of its own, on the same inputs, this
checkout's ``chip_smoke.py`` workloads at batch 4,099 and the kernels' own
launch geometry (32 slots a block at that batch, float32 and split alike):
K1 quadrotor fixed-100 cold, K2 warm (check 1, tolerance 1e-3), K3 a
12-tick adaptive mission, K4 a/b on the lander with its two cones
(fixed-100; check 2, tolerance 1e-2), static and with per-instance mu and
shift rows (``chip_smoke.py``'s), and K4 c a 10-tick coned mission.
``--algo bf16x3`` runs the split kernels at ``chip_smoke.py``'s settings
of them instead: K1 at polish 8, K2 warm at checks every 5 (tolerance
0.05), K3 12 ticks at checks every 5 (tolerance 1e-2), K4 a/b/c as above,
and K1 on the quadrotor at horizon 40 (20 iterations at polish 4) with the
operators in device memory at both register tiles.
Prints one JSON line: per run and output field whether the two agree bit
for bit and their largest difference. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
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
root, here, out, algo = sys.argv[1:5]
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
split = algo == "bf16x3"
bf = dict(algo="bf16x3") if split else {}
problem, _c, pp, x0s = cs.flagship(B, dev)
cold = FusedCarry.zeros(B, pp, device=dev)
k1 = dict(max_iter=100, polish=8) if split else dict(max_iter=100)
res["K1 fixed-100 cold"] = solve(fused_solve(x0s, cold, pp, **k1, **bf))
x1, warm = cs.warm_start(problem, pp, x0s, dev)
k2 = cs.BF16X3_ADAPTIVE if split else cs.WARM_KW
res["K2 warm"] = solve(fused_solve(x1, warm, pp, **k2, **bf))
k3 = cs.BF16X3_MISSION if split else cs.WARM_KW
res["K3 12 ticks"] = mission(fused_rollout(
    x0s, cold, pp, rollout_ops(problem, pp, device=dev), 12, **k3, **bf))
lproblem, _lc, lpp, lx0 = cs.lander(B, dev)
lcold = FusedCarry.zeros(B, lpp, device=dev)
cops = pad_cones(lpp, cs.lander_cones())
res["K4a"] = solve(fused_solve(lx0, lcold, lpp, cone_ops=cops,
                               **cs.LANDER_FIXED, **bf))
res["K4b"] = solve(fused_solve(lx0, lcold, lpp, cone_ops=cops,
                               **cs.LANDER_ADAPTIVE, **bf))
lin = lambda a, b: torch.linspace(a, b, B, device=dev)[None]
rows = dict(cone_mu_u=lin(0.6, 1.4), cone_shift_u=lin(2.5, 3.5),
            cone_mu_x=lin(1.5, 2.5), cone_shift_x=lin(0.05, 0.2))
for key, kw in (("K4a", cs.LANDER_FIXED), ("K4b", cs.LANDER_ADAPTIVE)):
    res[key + " per-instance rows"] = solve(fused_solve(
        lx0, lcold, lpp, cone_ops=cops, **rows, **kw, **bf))
res["K4c 10 ticks"] = mission(fused_rollout(
    lx0, lcold, lpp, rollout_ops(lproblem, lpp, device=dev), 10,
    cone_ops=cops, **cs.LANDER_MISSION, **bf))
if split:
    _p, _c, pp40, x40 = cs.flagship(B, dev, horizon=40)
    c40 = FusedCarry.zeros(B, pp40, device=dev)
    for ri in (8, 4):
        res[f"K1 N=40 device ri={ri}"] = solve(fused_solve(
            x40, c40, pp40, max_iter=20, polish=4, placement="device",
            register_tile=ri, **bf))
torch.save(res, out)
'''


def build_dir(root: pathlib.Path) -> str:
    """The build directory of a checkout's kernels for these tools (one per
    checkout, under the system's temporary directory)."""
    tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
    return str(pathlib.Path(tempfile.gettempdir()) / f"atm_fused_build_{tag}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b", nargs="?", default=str(HERE))
    ap.add_argument("--algo", default="f32", choices=("f32", "bf16x3"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    roots = [pathlib.Path(r).resolve() for r in (args.root_a, args.root_b)]
    tmps = [pathlib.Path(tempfile.mkdtemp(prefix="atm_fused_bits_"))
            for _ in roots]
    envs = [dict(os.environ, ATM_TORCH_BUILD_DIR=build_dir(r))
            for r in roots]
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
             str(tmp / "res.pt"), args.algo], env=env, capture_output=True,
            text=True)
        if proc.returncode != 0:
            sys.exit(f"{root}: {proc.stderr[-3000:]}")
        results.append(torch.load(tmp / "res.pt"))
    solve = ("U", "X", "stats", "D", "Y", "G", "Z", "V")
    names = {k: (("x_final", "us", "iters") + solve if len(v) > 8 else solve)
             for k, v in results[0].items()}
    row = {"roots": [str(r) for r in roots], "algo": args.algo, "runs": {}}
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
