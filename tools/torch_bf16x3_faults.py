#!/usr/bin/env python3
"""Planted faults in the split-bf16 fused kernels, read by ``chip_smoke.py``'s
checks of them, on one GPU.

    python3 tools/torch_bf16x3_faults.py [--out FILE] [--only FAULT ...]

For each fault in ``FAULTS``, copies ``ops/csrc/`` into a temporary
directory, plants the fault there by text substitutions in the kernels'
shared body (``admm_iteration.cuh``), and builds
``fused_admm_bf16x3.cu`` from the copy; ``sound`` builds the copy unchanged.
All builds, and the build of this checkout's other kernels, start together.
Then each library runs ``chip_smoke.bf16x3_checks`` in a process of its own
in place of the one built from this checkout, a few processes at a time.
Prints one JSON line per fault: how many checks failed, the first failures,
and the readings the checks' margins are set between (per case of the
arbiter, the kernel's 0.99-quantile and largest errors against the float64
plain version over the larger float32 plain version's, at their largest
over the fields; the median ratio and the nearer share of
``split_closer``; the nearer share and the median factor of each short
case; the float32 and golden comparisons; the bit-for-bit checks).
The whole readings go to ``--out`` (default
``build/bf16x3_faults.json``). Needs a CUDA device and nvcc. Nothing in
the checkout but that file is written.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "accelerated_tinympc_tpu_torch" / "ops" / "csrc"
BODY = "admm_iteration.cuh"

_FRESH = """\
        float ph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(ph, ah[u], bh0[j], bh1[j]);
        mma_bf16(pc, ah[u], bl0[j], bl1[j]);
        mma_bf16(pc, al[u], bh0[j], bh1[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc.hh[u][j][q] += ph[q];
          acc.cr[u][j][q] += pc[q];
        }
"""

# name: [(old, new), ...] in admm_iteration.cuh, each old found exactly once
FAULTS = {
    "sound": [],
    # F_SPLIT never set: every iteration float32 (the fragments still split)
    "no_split": [("(split ? F_SPLIT : 0)", "0")],
    # one of the three bf16 passes dropped
    "drop_hi_lo": [("        mma_bf16(pc, ah[u], bl0[j], bl1[j]);\n", "")],
    "drop_lo_hi": [("        mma_bf16(pc, al[u], bh0[j], bh1[j]);\n", "")],
    # the fixed schedule one iteration off
    "n3_plus_1": [(": it <= a.n3);", ": it <= a.n3 + 1);")],
    "n3_minus_1": [(": it <= a.n3);", ": it < a.n3);")],
    # the adaptive schedule splits the iteration at the cap
    "cap_splits": [("(it % a.check_every == 0 || last)",
                    "it % a.check_every == 0")],
    # the two sums kept running inside the tensor cores
    "running_accumulators": [(_FRESH, """\
        mma_bf16(acc.hh[u][j], ah[u], bh0[j], bh1[j]);
        mma_bf16(acc.cr[u][j], ah[u], bl0[j], bl1[j]);
        mma_bf16(acc.cr[u][j], al[u], bh0[j], bh1[j]);
""")],
    # all three passes into one running accumulator
    "one_accumulator": [(_FRESH, """\
        mma_bf16(acc.hh[u][j], ah[u], bh0[j], bh1[j]);
        mma_bf16(acc.hh[u][j], ah[u], bl0[j], bl1[j]);
        mma_bf16(acc.hh[u][j], al[u], bh0[j], bh1[j]);
""")],
}

BUILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
from accelerated_tinympc_tpu_torch.ops import _build
_build.build_all()
'''

RUN = r'''
import ctypes, importlib.util, json, math, sys
root, so, out = sys.argv[1:4]
sys.path.insert(0, root)
from accelerated_tinympc_tpu_torch.ops import _build
_build._libs["fused_admm_bf16x3"] = ctypes.CDLL(so)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
chk = cs.bf16x3_checks("cuda")


def ratio(a, b):
    return a / b if b else (0.0 if a == 0 else math.inf)


def worst(table):
    # the field where the kernel's reading over the larger float32 plain
    # version's is largest
    best = (None, -1.0)
    for k, v in table.items():
        r = ratio(v["kernel"], max(v["other_f32"], v["plain_f32_cpu"]))
        if r > best[1]:
            best = (k, r)
    return {"field": best[0], "ratio": best[1]}


cases = {}
for c in chk["cases"]:
    row = {"held_by": c.get("held_by"),
           "kernel_vs_split_plain": c.get("max_abs_err"),
           "closer_to_split": c.get("closer_to_split")}
    arb = c.get("arbiter_float64")
    if arb:
        row["q_over_f32"] = worst(arb["q0.99_vs_f64"])
        row["max_over_f32"] = worst(arb["err_vs_f64"])
        row["agree_f64"] = arb["agree_f64"]
        row["compared_share"] = arb["compared_share"]
    cases[c["case"]] = row
fails_in = lambda rows, pick=lambda f: True: sum(
    1 for r in rows for f in r["failures"] if pick(f))
near = lambda f: "median error" in f
summary = {
    "n_failures": len(chk["failures"]),
    "failed_by": {
        "arbiter_or_bars": fails_in(chk["cases"], lambda f: not near(f)),
        "split_closer": fails_in(chk["cases"], near),
        "separation": fails_in(chk["separation"]),
        "vs_float32_or_golden": fails_in(chk["vs_float32"]),
        "bit_exact": sum(1 for v in chk["bit_exact"].values() if not v)},
    "failures": [f[:300] for f in chk["failures"][:12]],
    "cases": cases,
    "separation": {r["case"]: {k: r[k] for k in (
        "nearer_share", "median_factor", "kernel_vs_split_plain",
        "others")} for r in chk["separation"]},
    "vs_float32": [{k: v for k, v in c.items() if k != "failures"}
                   for c in chk["vs_float32"]],
    "bit_exact": chk["bit_exact"]}
chk.pop("plain_ms")
with open(out, "w") as f:
    json.dump({"summary": summary, "checks": chk}, f, default=str)
'''


def plant(tmp: pathlib.Path, subs) -> pathlib.Path:
    """A copy of csrc/ under ``tmp`` with ``subs`` applied to the body."""
    dst = tmp / "csrc"
    shutil.copytree(CSRC, dst)
    body = dst / BODY
    text = body.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not found once in {BODY}")
        text = text.replace(old, new)
    body.write_text(text)
    return dst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(HERE / "build" /
                                         "bf16x3_faults.json"))
    ap.add_argument("--only", nargs="*", choices=list(FAULTS))
    ap.add_argument("--parallel", type=int, default=3,
                    help="check processes at once on the one card")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from accelerated_tinympc_tpu_torch.ops import _build

    names = args.only or list(FAULTS)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bf16x3_faults_"))
    try:
        builds = [subprocess.Popen([sys.executable, "-c", BUILD, str(HERE)])]
        libs = {}
        for name in names:
            src = plant(tmp / name, FAULTS[name])
            so = tmp / name / "libfused_admm_bf16x3.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(so), str(src / "fused_admm_bf16x3.cu")]
            builds.append(subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
            libs[name] = so
        for p in builds:
            _out, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"build failed ({p.args}):\n{err}")
        results, queue, running = {}, list(names), []
        while queue or running:
            while queue and len(running) < args.parallel:
                name = queue.pop(0)
                out = tmp / f"{name}.json"
                running.append((name, out, subprocess.Popen(
                    [sys.executable, "-c", RUN, str(HERE), str(libs[name]),
                     str(out)], env=dict(os.environ, PYTHONHASHSEED="0"))))
            name, out, proc = running.pop(0)
            proc.wait(timeout=900)
            if proc.returncode != 0 or not out.exists():
                results[name] = {"summary": {"error": proc.returncode}}
            else:
                results[name] = json.loads(out.read_text())
            print(json.dumps({"fault": name, **results[name]["summary"]}),
                  flush=True)
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
