#!/usr/bin/env python3
"""Cycles per knot step of the fleet kernels (K7/K8) on one GPU, split by
stage, from clock counters put into a copy of a checkout's
``ops/csrc/hetero_admm.cu``.

    python3 tools/torch_hetero_stage_clocks.py [ROOT] [--batches 65536 4096]

ROOT holds ``accelerated_tinympc_tpu_torch`` (default: this checkout). The
profilers that would split a kernel's time by stage (``ncu``) may not run
where the card is, so the script copies ROOT's package into a temporary
directory, adds counters to the copy and builds its ``hetero_admm.cu`` and
``riccati.cu`` (the workload's caches) there. Thread 0 of every block reads
``clock64()`` and adds the cycles to counters in shared memory, which go to
device memory at the end of the block; the counters cost a few
instructions per step, so the times printed beside them are above the
uninstrumented kernels'.

Two generations of the kernel are read:

* the lane-group kernel (``hetero_kernel<G, ...>``, a group of G lanes an
  instance, products by shuffle; by text edits): per instance its setup
  (operands into shared memory, matrix rows into registers), per knot the
  forward sweep (without and with residuals) and the backward sweep, per
  block the write-back, and the iterations the block's first warp ran;
  beside them, from the solve's own stats, the mean iterations against
  the mean over warps and over blocks of their largest (a warp and a block
  run until their slowest instance is done);
* the kernel of stacked rows and per-instance slots (its stage hooks
  ``ATM_CLK``, empty unless defined): per instance taken the claim and
  load, per knot the forward and backward sweeps, per instance retired
  the write-back, per iteration the rest (checks, bookkeeping), and the
  cycles thread 0 spent waiting for its warp-mate's refills.

The workloads are ``tools/torch_stream_times.py``'s: the robust sweep's
family (the quadrotor's plant perturbed by 3 %, N=10), K7 fixed 100 cold,
K8 check 1 at tolerance 1e-3 warm after a 12-tick fleet mission. Also
printed: each instantiation's registers (``-Xptxas -v`` of an
uninstrumented build of ROOT's source) and, for 12/4, the blocks an SM
holds at once.

Prints one JSON line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]
NCLK = 12

# ------------------------------------------------- the lane-group kernel --
# Counters: 0 setup, 1 fwd cycles (no residuals), 2 their calls, 3 fwd
# cycles with residuals, 4 their calls, 5 bwd cycles, 6 bwd calls, 7
# iterations, 8 write-back, 9 blocks.
COUNTERS = f"""
__device__ unsigned long long g_clk[{NCLK}];
__shared__ unsigned long long s_clk_[{NCLK}];
#define ATM_ADD(k, v) do {{ if (threadIdx.x == 0) s_clk_[k] += (v); }} while (0)
"""
READ_BACK = f"""
extern "C" int atm_hetero_clocks(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, atm_hetero::g_clk,
                                       sizeof(atm_hetero::g_clk));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{NCLK}] = {{0}};
  return (int)cudaMemcpyToSymbol(atm_hetero::g_clk, z, sizeof(z));
}}
"""
LANE_GROUP_PROBE = """
extern "C" int atm_probe_resident(int adaptive, int smem) {
  auto k = adaptive ? atm_hetero::hetero_kernel<16, true, false>
                    : atm_hetero::hetero_kernel<16, false, false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, k, atm_hetero::THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}
"""
EDITS = [
    ("""  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;""",
     f"""  if (threadIdx.x == 0)
    for (int k_ = 0; k_ < {NCLK}; ++k_) s_clk_[k_] = 0ull;
  const unsigned long long c0_ = clock64();
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;"""),
    ("""  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = (float)a.max_iter, solved = 0.0f;""",
     """  ATM_ADD(0, clock64() - c0_);
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = (float)a.max_iter, solved = 0.0f;"""),
    ("""      forward<G, CONES>(a, s, lane, 0, 0, it == a.max_iter - 1, valid, r);
      backward<G>(a, s, lane, 0, valid);""",
     """      const bool rs_ = it == a.max_iter - 1;
      unsigned long long t_ = clock64();
      forward<G, CONES>(a, s, lane, 0, 0, rs_, valid, r);
      ATM_ADD(rs_ ? 3 : 1, clock64() - t_);
      ATM_ADD(rs_ ? 4 : 2, 1ull);
      t_ = clock64();
      backward<G>(a, s, lane, 0, valid);
      ATM_ADD(5, clock64() - t_);
      ATM_ADD(6, 1ull);
      ATM_ADD(7, 1ull);"""),
    ("""      forward<G, CONES>(a, s, lane, par, par ^ 1, chk, live, rr);""",
     """      unsigned long long t_ = clock64();
      forward<G, CONES>(a, s, lane, par, par ^ 1, chk, live, rr);
      ATM_ADD(chk ? 3 : 1, clock64() - t_);
      ATM_ADD(chk ? 4 : 2, 1ull);"""),
    ("""      backward<G>(a, s, lane, par ^ 1, cont);""",
     """      t_ = clock64();
      backward<G>(a, s, lane, par ^ 1, cont);
      ATM_ADD(5, clock64() - t_);
      ATM_ADD(6, 1ull);
      ATM_ADD(7, 1ull);"""),
    ("""  if (!valid) return;""",
     """  const unsigned long long w0_ = clock64();
  if (!valid) return;"""),
    ("""    st[6] = 0.0f; st[7] = 0.0f;
  }
}""", f"""    st[6] = 0.0f; st[7] = 0.0f;
  }}
  ATM_ADD(8, clock64() - w0_);
  ATM_ADD(9, 1ull);
  if (threadIdx.x == 0)
    for (int k_ = 0; k_ < {NCLK}; ++k_) atomicAdd(&g_clk[k_], s_clk_[k_]);
}}"""),
]

# ------------------------------- the kernel of stacked rows and slots --
# ATM_CLK(k) adds the cycles since the last mark to counter k,
# ATM_CLK_COUNT(k) counts. Counters: 0 claim and load, 1 fwd knot steps, 2
# bwd knot steps, 3 write-back, 4 the rest of an iteration, 5 waiting for
# the warp-mate, 6 fwd knots, 7 bwd knots, 8 iterations, 9 instances
# taken, 10 blocks, 11 cycles from the first mark to the last.
HOOK_DEFS = f"""
#include <cuda_runtime.h>
namespace atm_hetero {{ __device__ unsigned long long g_clkh[{NCLK}]; }}
#define ATM_CLK_BEGIN() __shared__ unsigned long long s_ck_[{NCLK}]; \\
  if (threadIdx.x == 0) for (int k_ = 0; k_ < {NCLK}; ++k_) s_ck_[k_] = 0ull; \\
  const unsigned long long cb_ = clock64(); unsigned long long c0_ = cb_
#define ATM_CLK(k) do {{ const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) s_ck_[k] += t_ - c0_; c0_ = t_; }} while (0)
#define ATM_CLK_COUNT(k) do {{ if (threadIdx.x == 0) ++s_ck_[k]; }} while (0)
#define ATM_CLK_END() do {{ if (threadIdx.x == 0) {{ s_ck_[10] = 1; \\
  s_ck_[11] = clock64() - cb_; \\
  for (int k_ = 0; k_ < {NCLK}; ++k_) \\
    atomicAdd(&atm_hetero::g_clkh[k_], s_ck_[k_]); }} }} while (0)
"""
HOOK_READ_BACK = f"""
extern "C" int atm_hetero_clocks(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, atm_hetero::g_clkh,
                                       sizeof(atm_hetero::g_clkh));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{NCLK}] = {{0}};
  return (int)cudaMemcpyToSymbol(atm_hetero::g_clkh, z, sizeof(z));
}}
"""


def lane_group(src: str) -> bool:
    """Whether a hetero_admm.cu is the lane-group kernel."""
    return "struct Inst" in src


def instrumented_copy(root: pathlib.Path, dst: pathlib.Path) -> bool:
    """Copy ROOT's package to dst with counters in hetero_admm.cu; returns
    whether it is the lane-group kernel."""
    pkg = dst / "accelerated_tinympc_tpu_torch"
    shutil.copytree(root / "accelerated_tinympc_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "ops" / "csrc" / "hetero_admm.cu"
    src = cu.read_text()
    if not lane_group(src):
        cu.write_text(HOOK_DEFS + src + HOOK_READ_BACK)
        return False
    src = src.replace("namespace atm_hetero {\n",
                      "namespace atm_hetero {\n" + COUNTERS, 1)
    for old, new in EDITS:
        if src.count(old) != 1:
            sys.exit(f"{cu}: text not found once:\n{old}")
        src = src.replace(old, new)
    cu.write_text(src + READ_BACK)
    return True


def registers(root: pathlib.Path, tmp: pathlib.Path, tssc, old: bool,
              smem: dict) -> dict:
    """Registers of each hetero_kernel instantiation (an uninstrumented
    build of ROOT's source) and, at 12/4, the blocks an SM holds at once in
    each mode (``smem``: dynamic shared memory of a block by mode)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    cu = root / "accelerated_tinympc_tpu_torch" / "ops" / "csrc" / \
        "hetero_admm.cu"
    probe = tmp / "probe"
    probe.mkdir(exist_ok=True)
    for hdr in cu.parent.glob("*.cuh"):
        shutil.copy(hdr, probe / hdr.name)
    copy = probe / "hetero_admm.cu"
    copy.write_text(cu.read_text() + (LANE_GROUP_PROBE if old else ""))
    log = tssc.nvcc_build(copy, probe / "libprobe.so")
    out = {"ptxas": [r for r in cs.ptxas_per_kernel(log)
                     if "hetero_kernel" in r["kernel"]]}
    if old:
        lib = ctypes.CDLL(str(probe / "libprobe.so"))
        out["resident_blocks_per_sm"] = {
            mode: lib.atm_probe_resident(ad, smem[mode])
            for mode, ad in (("fixed", 0), ("adaptive", 1))}
    return out


def block_tails(stats, per_warp: int, per_block: int) -> dict:
    """Mean iterations against the mean over consecutive groups (a warp's,
    a block's instances) of their largest: what a warp or a block that runs
    until its slowest instance is done pays."""
    its = stats[:, 0].double()
    out = {"iters_mean": float(its.mean())}
    for name, k in (("warp", per_warp), ("block", per_block)):
        n = its.numel() // k * k
        out[f"{name}_max_mean"] = float(its[:n].reshape(-1, k).amax(1)
                                        .mean())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--batches", type=int, nargs="+", default=[65536, 4096])
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's timer
    sys.path.insert(0, str(HERE / "tools"))
    import torch_stream_stage_clocks as tssc   # build helpers
    import torch_stream_times as tst           # the timed workloads

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_hetero_clocks_"))
    try:
        old = instrumented_copy(root, tmp)
        os.environ["ATM_TORCH_BUILD_DIR"] = str(tmp / "build")
        pkg = tmp / "accelerated_tinympc_tpu_torch"
        tssc.prebuild(pkg, ("hetero_admm", "riccati"))
        sys.path.insert(0, str(tmp))
        import torch

        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        import accelerated_tinympc_tpu_torch as atm
        from accelerated_tinympc_tpu_torch.api.mpc import fleet_mpc_rollout
        from accelerated_tinympc_tpu_torch.ops import hetero_admm as ha

        assert pathlib.Path(atm.__file__).resolve().is_relative_to(tmp)
        lib = ha._library()
        lib.atm_hetero_clocks.argtypes = [ctypes.c_void_p]
        per = lambda a, n: round(a / max(n, 1), 1)
        N = 10

        def counters(fn):
            buf = (ctypes.c_ulonglong * NCLK)()
            fn()
            torch.cuda.synchronize()
            assert lib.atm_hetero_clocks(ctypes.addressof(buf)) == 0
            ms = cs.cuda_ms(fn, 1)            # a warm-up and a timed call
            assert lib.atm_hetero_clocks(ctypes.addressof(buf)) == 0
            return ms, [x / 2 for x in buf]   # two calls

        def measure_old(fn):
            ms, v = counters(fn)
            fwd = v[2] + v[4]
            return {
                "ms": ms, "iterations_per_block": per(v[7], v[9]),
                "setup_per_block": per(v[0], v[9]),
                "fwd_knot": per(v[1], v[2] * N) if v[2] else None,
                "fwd_knot_with_residuals": per(v[3], v[4] * N),
                "bwd_knot": per(v[5], v[6] * (N - 1)),
                "fwd_calls_per_block": per(fwd, v[9]),
                "writeback_per_block": per(v[8], v[9])}

        def measure_hooks(fn):
            ms, v = counters(fn)
            return {
                "ms": ms, "iterations_per_block": per(v[8], v[10]),
                "instances_per_block": per(v[9], v[10]),
                "claim_and_load_per_instance": per(v[0], v[9]),
                "fwd_knot": per(v[1], v[6]), "bwd_knot": per(v[2], v[7]),
                "writeback_per_instance": per(v[3], v[9]),
                "rest_per_iteration": per(v[4], v[8]),
                "waiting_for_warp_mate_per_block": per(v[5], v[10]),
                "cycles_per_block": per(v[11], v[10])}

        measure = measure_old if old else measure_hooks
        row = {"root": str(root), "lane_group": old,
               "device": torch.cuda.get_device_name(0),
               "nvidia_smi": subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip()}
        kh8 = dict(max_iter=100, check_termination=1, abs_pri_tol=1e-3,
                   abs_dua_tol=1e-3)
        for Bn in args.batches:
            fam = tst.robust_family(atm, Bn)
            hp = ha.pad_hetero_from_plants(fam[0].A, fam[0].B, fam[0].Q,
                                           fam[0].R, fam[1], fam[0])[0]
            cold = ha.HeteroCarry.zeros(hp)
            xw, _us, cw = fleet_mpc_rollout(hp, fam[0], fam[2], 12, **kh8)
            cw = cw.reset_duals()
            k7 = lambda: ha.hetero_solve(fam[2], cold, hp, max_iter=100)
            k8 = lambda: ha.hetero_solve(xw, cw, hp, **kh8)
            row[f"K7_b{Bn}"] = measure(k7)
            row[f"K8_b{Bn}"] = measure(k8)
            if old:
                G, ipb, _smem = ha.launch_geometry(hp.dims)
                row[f"K8_b{Bn}"]["tails"] = block_tails(k8().stats, 32 // G,
                                                        ipb)
            else:
                row[f"K8_b{Bn}"]["iters_mean"] = float(
                    k8().stats[:, 0].mean())
            del fam, hp, cold, xw, cw
        if old:
            smem = {m: ha.launch_geometry((12, 4, N))[2]
                    for m in ("fixed", "adaptive")}
        else:
            smem = {m: ha.hetero_plan(12, 4, N, adaptive=m == "adaptive")[
                "smem_bytes"] for m in ("fixed", "adaptive")}
        geo = registers(root, tmp, tssc, old, smem)
        if not old:
            geo["resident_blocks_per_sm"] = {
                m: ha.hetero_resident(12, 4, N, adaptive=m == "adaptive")
                for m in ("fixed", "adaptive")}
        row["geometry_12_4"] = geo
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
