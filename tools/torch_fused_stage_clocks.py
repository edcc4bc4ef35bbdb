#!/usr/bin/env python3
"""Cycles per stage of the fused kernels' iteration (K1-K4, float32 and
split-bf16) on one GPU, from clock counters put into a copy of a checkout's
kernels.

    python3 tools/torch_fused_stage_clocks.py [ROOT] [--only K1,K3,...]
        [--algos f32,bf16x3] [--cone-path fused|three-pass]
        [--variants registers,no_dispatch,no_products,wave_adjacent_lanes,
                    wave_runtime_widths]

The profilers that would split a kernel's time by stage (``ncu``) may not
run where the card is, so this script copies ROOT's
``accelerated_tinympc_tpu_torch`` (default: this checkout) into a temporary
directory and builds it with clock counters. The iteration body
(``ops/csrc/admm_iteration.cuh``) carries stage hooks (``ATM_CLK`` and
kin, empty unless defined); the script defines them in front of the copy's
``fused_admm.cu`` and ``fused_admm_bf16x3.cu`` and appends a C entry that
reads the counters back. A source without the hooks stops the script.

Block counters (thread 0 of every block reads ``clock64()`` after each
barrier of the iteration loop; cycles per block-iteration): ``forward``
the forward stage (with the split rows' product and elementwise work where
they run beside it; with the cones where the coned float32 kernels fold
them into it), ``cone`` and ``finish`` (the three coned passes: the
split-bf16 coned kernels, and the float32 ones with ``--cone-path
three-pass`` or in a checkout without the fused pass),
``backward`` the bookkeeping with both backward products, ``refill`` the
refill check and refill. Warp counters (lane 0 of every warp, cycles per
warp and block-iteration): ``w_split_fwd``, ``w_forward``, ``w_split_bwd``,
``w_backward``, the time a warp spends in each product's code before the
next barrier, so the gap to the block counter is the wait at the barrier;
in the folded coned pass ``w_forward`` is the product and the box clip,
``w_cone`` the warp's cone projections and ``w_cone_finish`` its dual
ascent and residual terms.
Per retired slot, the cycles its warp spent retiring it and loading the
next. The counters live in shared memory and are added to device memory once
per block, so the times printed beside them are a little above the
uninstrumented kernels'.

Workloads: this checkout's ``chip_smoke.py`` workload functions at batch
65,536, each split kernel beside its float32 twin on the same schedule:
K1 quadrotor fixed-100 cold (split: polish 8; ``K1_device`` with the
operators read from device memory at K1's slots a block), K2 warm check 1,
K3 70
ticks at checks every 5 (tol 1e-2), K4 a/b/c on the lander with both
cones (c: 30 ticks), and ``K4a_box``, ``K4b_box``, ``K4c_box``, their
box-only twins (the same schedules without the cones). Beside the
readings: the SASS instructions of each split kernel and of each coned
float32 kernel (``cuobjdump``, where the toolkit has it) and their
registers and spills (``-Xptxas -v``), and those of the box-only float32
kernels (``box_kernels``). Prints one JSON line. Needs a CUDA device and
nvcc.

``--variants`` also clocks throwaway variants of the shared iteration body
(``forward_stage``, ``forward_product``, ``backward_stage`` of ROOT's
``admm_iteration.cuh``, so K2-K4 and, up to the checkout that gave K1 a
body of its own, K1), each in a copy of its own built beside the
unchanged one, all compilers started together, measured in turn: their
numbers are wrong on purpose, only their cycles count. ``registers``: the
forward stage's elementwise work without its dual, slack and x0-term
traffic through shared memory (zeros in place of the loads, no stores but
S); ``no_dispatch``: without the per-row ``done``, ``flags`` and ``zpar``
reads and the three-way mode dispatch; ``no_products``: without the
forward and backward products. Each variant's readings are under
``variant:<name>``; a text of a variant not found once in the body stops
the script. ``wave_adjacent_lanes`` clocks K1's own body
(``fixed_waves.cuh``) with its backward product's lanes adjacent, as the
shared body's, in place of 32 / H apart; ``wave_runtime_widths`` with its
widths and depth split read at run time at every shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]

NCLK = 18
NWARP = NCLK - 10
# Counter indices: block counters, slot counters, warp counters.
BLOCK = {"forward": 0, "cone": 1, "finish": 2, "backward": 3, "refill": 4}
WARP = {"w_split_fwd": 10, "w_forward": 11, "w_split_bwd": 12,
        "w_backward": 13, "w_split_fwd_finish": 14, "w_split_fwd_rest": 15,
        "w_cone": 16, "w_cone_finish": 17}
ITERS, RETIRED, RETIRE, LOAD = 7, 8, 5, 6

# Block counters in shared memory (thread 0 adds them to g_clk at the end);
# warp spans in shared memory per warp: ATM_WCLK_BEGIN() marks, ATM_WCLK(k)
# adds the cycles since the warp's last mark to counter k and marks again
# (usable in any function of the body: the arrays are at namespace scope).
HOOK_DEFS = """
#include <cuda_runtime.h>
namespace atm {
__device__ unsigned long long g_clk[%(n)d];
__shared__ unsigned long long s_ck_[%(n)d];
__shared__ unsigned long long s_wk_[8][%(w)d];
__shared__ unsigned long long s_wt_[8];
}
#define ATM_CLK_BEGIN() \\
  if (threadIdx.x == 0) for (int k_ = 0; k_ < %(n)d; ++k_) atm::s_ck_[k_] = 0ull; \\
  if ((threadIdx.x & 31) == 0 && threadIdx.x < 256) \\
    for (int k_ = 0; k_ < %(w)d; ++k_) atm::s_wk_[threadIdx.x >> 5][k_] = 0ull; \\
  unsigned long long c0_ = 0ull
#define ATM_CLK_MARK() c0_ = clock64()
#define ATM_CLK(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) atm::s_ck_[k] += t_ - c0_; c0_ = t_; } while (0)
#define ATM_CLK_COUNT(k) do { if (threadIdx.x == 0) ++atm::s_ck_[k]; } while (0)
#define ATM_WCLK_BEGIN() do { if ((threadIdx.x & 31) == 0) \\
  atm::s_wt_[threadIdx.x >> 5] = clock64(); } while (0)
#define ATM_WCLK(k) do { const unsigned long long t_ = clock64(); \\
  if ((threadIdx.x & 31) == 0) { \\
    atm::s_wk_[threadIdx.x >> 5][(k) - 10] += t_ - atm::s_wt_[threadIdx.x >> 5]; \\
    atm::s_wt_[threadIdx.x >> 5] = t_; } } while (0)
#define ATM_SCLK_BEGIN() const unsigned long long c0s_ = clock64()
#define ATM_SCLK_MID() const unsigned long long c1s_ = clock64()
#define ATM_SCLK_END(initial) do { __syncwarp(); \\
  const unsigned long long c2s_ = clock64(); \\
  if (!(initial) && (threadIdx.x & 31) == 0) { \\
    atomicAdd(&atm::g_clk[5], c1s_ - c0s_); \\
    atomicAdd(&atm::g_clk[6], c2s_ - c1s_); \\
    atomicAdd(&atm::g_clk[8], 1ull); } } while (0)
#define ATM_CLK_END() do { __syncthreads(); if (threadIdx.x == 0) { \\
  for (int k_ = 0; k_ < 10; ++k_) \\
    if (k_ != 5 && k_ != 6 && k_ != 8) \\
      atomicAdd(&atm::g_clk[k_], atm::s_ck_[k_]); \\
  for (int w_ = 0; w_ < (int)(blockDim.x >> 5); ++w_) \\
    for (int k_ = 0; k_ < %(w)d; ++k_) atomicAdd(&atm::g_clk[10 + k_], \\
                                             atm::s_wk_[w_][k_]); } } while (0)
""" % {"n": NCLK, "w": NWARP}
READ_BACK = """
extern "C" int atm_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, atm::g_clk, sizeof(atm::g_clk));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[%(n)d] = {0};
  return (int)cudaMemcpyToSymbol(atm::g_clk, z, sizeof(z));
}
""" % {"n": NCLK}

# The throwaway variants (--variants): text substitutions, each found
# exactly once, in admm_iteration.cuh (the shared body) or, where an entry
# names it first, in another source of csrc/.
_ROW_LOADS = """\
          const int zp = s.zpar[i];
          const float4 xb4 = *reinterpret_cast<const float4*>(s.Xb + idx);
          const float4 y4 = *reinterpret_cast<const float4*>(s.YG + idx);
          const float4 z4 =
              *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
"""
_ROW_STORES = """\
          *reinterpret_cast<float4*>(s.YG + idx) =
              make_float4(o1[0], o1[1], o1[2], o1[3]);
          *reinterpret_cast<float4*>(s.ZV + (zp ^ 1) * zstride + idx) =
              make_float4(zn[0], zn[1], zn[2], zn[3]);
"""
_ROW_FLAGS = """\
      dn[r] = !active || s.done[i0 + r] != LIVE;
      fl[r] = dn[r] ? 0 : s.flags[i0 + r];
      if constexpr (SPLIT) {"""
_DISPATCH = """\
    const unsigned wfl = __reduce_or_sync(0xffffffffu, (unsigned)anyfl);
    if (wfl == 0u) finish(std::integral_constant<int, 0>{});
    else if (wfl == (unsigned)F_CHECK) finish(std::integral_constant<int, 1>{});
    else finish(std::integral_constant<int, 2>{});
  }
}

// The exact projection"""
_ZERO4 = "make_float4(0.0f, 0.0f, 0.0f, 0.0f)"
VARIANTS = {
    "registers": [
        (_ROW_LOADS, "          const int zp = s.zpar[i];\n"
         f"          const float4 xb4 = {_ZERO4};\n"
         f"          const float4 y4 = {_ZERO4};\n"
         f"          const float4 z4 = {_ZERO4};\n"),
        (_ROW_STORES, "          (void)zp;\n")],
    "no_dispatch": [
        (_ROW_FLAGS, "      dn[r] = !active;\n      fl[r] = 0;\n"
         "      if constexpr (SPLIT) {"),
        (_ROW_LOADS, _ROW_LOADS.replace("s.zpar[i]", "0")),
        (_DISPATCH, "    finish(std::integral_constant<int, 0>{});\n"
         + _DISPATCH.split("\n", 4)[4])],
    "no_products": [
        ("  if (live) {\n    const float* Dg = s.D + i0 * d.DuP;",
         "  if (false) {\n    const float* Dg = s.D + i0 * d.DuP;"),
        ("    if (live) {\n      // The split kernels read Wb",
         "    if (false) {\n      // The split kernels read Wb")],
    # K1's own body with its backward lanes adjacent, as backward_stage's
    "wave_adjacent_lanes": [
        ("fixed_waves.cuh", "  const int tw = lane & (TW - 1);\n"
         "  const int hl = lane / TW;\n",
         "  const int tw = lane / H;\n  const int hl = lane & (H - 1);\n"),
        ("fixed_waves.cuh", "for (int off = TW; off < 32; off <<= 1)",
         "for (int off = 1; off < H; off <<= 1)")],
    # K1's own body with every width and the depth split read at run time
    "wave_runtime_widths": [
        ("fused_entry.cuh", "  if (!a.d.gops && a.d.DuP == U",
         "  if (false && a.d.DuP == U")],
}


def instrumented_copy(root: pathlib.Path, dst: pathlib.Path,
                      variant: str = "") -> str:
    """Copies ROOT's package to ``dst`` with the stage hooks defined (and
    the substitutions of ``variant``, :data:`VARIANTS`, made)."""
    pkg = dst / "accelerated_tinympc_tpu_torch"
    shutil.copytree(root / "accelerated_tinympc_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = pkg / "ops" / "csrc"
    cuh = csrc / "admm_iteration.cuh"
    if "ATM_CLK_BEGIN()" not in cuh.read_text():
        sys.exit(f"{cuh}: no stage hooks")
    for sub in VARIANTS[variant] if variant else ():
        src = csrc / (sub[0] if len(sub) == 3 else "admm_iteration.cuh")
        old, new = sub[-2:]
        text = src.read_text()
        if text.count(old) != 1:
            sys.exit(f"{src}: variant {variant}: text found "
                     f"{text.count(old)} times:\n{old}")
        src.write_text(text.replace(old, new))
    for name in ("fused_admm.cu", "fused_admm_bf16x3.cu"):
        cu = csrc / name
        cu.write_text(HOOK_DEFS + cu.read_text() + READ_BACK)


def build_fused(_build, names, copies=()) -> dict:
    """Builds the copy's fused libraries ``names`` (``fused_admm``,
    ``fused_admm_bf16x3``) with its own ``_build`` flags, and the float32
    one of each variant copy in ``copies`` (``{variant: package dir}``,
    into that copy), all compilers started together. Returns the logs by
    library name (``fused_admm@<variant>`` for the variants')."""
    import subprocess

    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(name, _build.CSRC, _build.library_path(name)) for name in names]
    jobs += [(f"fused_admm@{v}", pkg / "ops" / "csrc", variant_library(pkg))
             for v, pkg in copies.items()]
    procs, logs = [], {}
    for name, csrc, so in jobs:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
               "-o", str(so), str(csrc / f"{name.split('@')[0]}.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for the instrumented {name}:\n{log}")
        logs[name] = log
    return logs


def variant_library(pkg: pathlib.Path) -> pathlib.Path:
    """Where a variant copy's float32 library is built."""
    return pkg / "libfused_admm_variant.so"


def kernel_sizes(_build, log: str, name: str) -> dict:
    """Per kernel of library ``name`` (``_build``'s): SASS instructions
    (``cuobjdump``) and the compiler's registers, stack and spill line."""
    import re
    import shutil as _sh
    import subprocess

    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?\n(.*?)\n"
                         r"ptxas info\s*: Used (\d+) registers", log, re.S):
        out[m.group(1)] = {"registers": int(m.group(3)),
                           "spills": m.group(2).strip().splitlines()[-1].strip()}
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists() and _sh.which("cuobjdump"):
        cuobjdump = pathlib.Path(_sh.which("cuobjdump"))
    if cuobjdump.exists():
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                fn = m.group(1)
                out.setdefault(fn, {})["sass_instructions"] = 0
            elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                out[fn]["sass_instructions"] += 1
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--only", default="",
                    help="comma-separated workloads (K1,K1_device,K2,K3,K4a,"
                    "K4b,K4c,K4a_box,K4b_box,K4c_box)")
    ap.add_argument("--algos", default="f32,bf16x3")
    ap.add_argument("--variants", default="",
                    help="comma-separated variants of the shared body "
                    f"({','.join(VARIANTS)}), clocked after the body itself")
    ap.add_argument("--cone-path", default="fused",
                    choices=("fused", "three-pass"),
                    help="the coned float32 kernels' slack stage (a checkout "
                    "without the fused cone pass runs three passes anyway)")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's workloads and timer

    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in VARIANTS:
            sys.exit(f"unknown variant {v!r}; take {', '.join(VARIANTS)}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_stage_clocks_"))
    try:
        instrumented_copy(root, tmp)
        copies = {}
        for v in variants:
            instrumented_copy(root, tmp / "variants" / v, v)
            copies[v] = tmp / "variants" / v / "accelerated_tinympc_tpu_torch"
        os.environ["ATM_TORCH_BUILD_DIR"] = str(tmp / "build")
        sys.path.insert(0, str(tmp))
        import torch

        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        from accelerated_tinympc_tpu_torch.ops import (
            FusedCarry, _build, fused_admm, fused_rollout, fused_solve,
            pad_cones, rollout_ops,
        )

        if args.cone_path == "three-pass":
            fused_admm.FUSED_CONES = False
        algos = args.algos.split(",")
        if variants and "f32" not in algos:
            sys.exit("the variants are float32 builds: take --algos f32")
        names = [{"f32": "fused_admm", "bf16x3": "fused_admm_bf16x3"}[a]
                 for a in algos]
        logs = build_fused(_build, names, copies)
        libs = {a: fused_admm._library(a) for a in algos}
        buf = (ctypes.c_ulonglong * NCLK)()

        def measure(fn, algo, dims, batch):
            lib = libs[algo]
            run = lambda: fn(algo=algo)
            run()
            torch.cuda.synchronize()
            assert lib.atm_clocks(buf) == 0   # read and zero
            ms = cs.cuda_ms(run, 1)           # a warm-up and a timed call
            assert lib.atm_clocks(buf) == 0
            v = list(buf)
            # two runs (the warm-up and the timed one) in the counters
            its, slots = max(v[ITERS], 1), max(v[RETIRED], 1)
            tile, threads = fused_admm._geometry(
                dims, batch, "cuda", None, None,
                split=algo == "bf16x3")[:2]
            per = lambda k: round(v[k] / its, 1)
            wper = lambda k: round(v[k] / its / (threads // 32), 1)
            return {"ms": ms, "tile": tile, "block_iters": v[ITERS] / 2,
                    "cycles_per_block_iter": {
                        name: per(k) for name, k in BLOCK.items()},
                    "cycles_per_warp_iter": {
                        name: wper(k) for name, k in WARP.items()},
                    "retire_cycles_per_slot": round(v[RETIRE] / slots, 1),
                    "load_cycles_per_slot": round(v[LOAD] / slots, 1)}

        B, dev = cs.MAIN_BATCH, "cuda"
        problem, _c, pp, x0s = cs.flagship(B, dev)
        cold = FusedCarry.zeros(B, pp, device=dev)
        x1, warm = cs.warm_start(problem, pp, x0s, dev)
        rops = rollout_ops(problem, pp, device=dev)
        lproblem, _lc, lpp, lx = cs.lander(B, dev)
        lcold = FusedCarry.zeros(B, lpp, device=dev)
        cops = pad_cones(lpp, cs.lander_cones())
        lrops = rollout_ops(lproblem, lpp, device=dev)
        p8 = dict(max_iter=100, polish=8)

        def k1(algo):
            return fused_solve(x0s, cold, pp, **(p8 if algo == "bf16x3" else
                                                 dict(max_iter=100)),
                               algo=algo)

        work = {
            "K1": (k1, pp.dims),
            # K1 with its operators read from device memory (the same
            # geometry and bits)
            "K1_device": (lambda algo: fused_solve(
                x0s, cold, pp, max_iter=100, placement="device",
                batch_tile=fused_admm._geometry(pp.dims, B, dev, None,
                                                None)[0], algo=algo),
                pp.dims),
            "K2": (lambda algo: fused_solve(x1, warm, pp, **cs.WARM_KW,
                                            algo=algo), pp.dims),
            "K3": (lambda algo: fused_rollout(
                x0s, cold, pp, rops, 70, **cs.BF16X3_MISSION, algo=algo),
                pp.dims),
            "K4a": (lambda algo: fused_solve(
                lx, lcold, lpp, cone_ops=cops, **cs.LANDER_FIXED, algo=algo),
                lpp.dims),
            "K4b": (lambda algo: fused_solve(
                lx, lcold, lpp, cone_ops=cops, **cs.LANDER_ADAPTIVE,
                algo=algo), lpp.dims),
            "K4c": (lambda algo: fused_rollout(
                lx, lcold, lpp, lrops, 30, cone_ops=cops,
                **cs.LANDER_MISSION, algo=algo), lpp.dims),
            # the box-only twins of K4 a/b/c: the lander's schedules
            # without the cones
            "K4a_box": (lambda algo: fused_solve(
                lx, lcold, lpp, **cs.LANDER_FIXED, algo=algo), lpp.dims),
            "K4b_box": (lambda algo: fused_solve(
                lx, lcold, lpp, **cs.LANDER_ADAPTIVE, algo=algo), lpp.dims),
            "K4c_box": (lambda algo: fused_rollout(
                lx, lcold, lpp, lrops, 30, **cs.LANDER_MISSION, algo=algo),
                lpp.dims),
        }
        only = [k for k in args.only.split(",") if k] or list(work)
        row = {"root": str(root), "cone_path": args.cone_path,
               "device": torch.cuda.get_device_name(0)}
        for key in only:
            fn, dims = work[key]
            row[key] = {algo: measure(fn, algo, dims, B) for algo in algos}
        body_lib = libs.get("f32")
        for v, pkg in copies.items():
            # the variant's float32 library in place of the body's
            _build._libs["fused_admm"] = ctypes.CDLL(
                str(variant_library(pkg)))
            libs["f32"] = fused_admm._library("f32")
            row[f"variant:{v}"] = {
                key: {"f32": measure(work[key][0], "f32", work[key][1], B)}
                for key in only}
        if copies:
            _build._libs["fused_admm"] = body_lib
        if "bf16x3" in algos:
            row["split_kernels"] = {
                k: v for k, v in kernel_sizes(
                    _build, logs["fused_admm_bf16x3"],
                    "fused_admm_bf16x3").items() if "bf16x3" in k}
        if "f32" in algos:
            sizes = kernel_sizes(_build, logs["fused_admm"], "fused_admm")
            row["coned_kernels"] = {k: v for k, v in sizes.items()
                                    if "cones" in k}
            row["box_kernels"] = {k: v for k, v in sizes.items()
                                  if "cones" not in k}
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
