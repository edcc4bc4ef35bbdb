#!/usr/bin/env python3
"""Cycles per stage of the fused kernels' iteration (K1, K2, K4 a/b) on one
GPU, from clock counters put into a copy of a checkout's kernels.

    python3 tools/torch_fused_stage_clocks.py [ROOT]

The profilers that would split a kernel's time by stage (``ncu``) may not
run where the card is, so this script copies ROOT's
``accelerated_tinympc_tpu_torch`` (default: this checkout) into a temporary
directory and adds counters to the copy's ``ops/csrc/admm_iteration.cuh``:
thread 0 of every block reads ``clock64()`` after each barrier of the
iteration loop and adds the difference to a device array, which a small C
entry added to ``fused_admm.cu`` reads back. The stages are the forward
product with the elementwise stage, the cone pass, the finish pass, the
bookkeeping with the backward product, and (slot kernels) the refill check
and refill; per retired slot, the cycles its warp spent retiring it and
loading the next. Two kernel layouts are known: the lockstep blocks of the
first port (``solve_core``) and the slot kernels (``run_block``); the
script stops if ROOT's source matches neither (the slot kernels templated
over the operators' placement, and over the register tile's slots, count
as the second). The counters cost one
global atomic per stage and block-iteration, so the times printed beside
them are a little above the uninstrumented kernels'.

The workloads are this checkout's ``chip_smoke.py`` builders at batch
65,536. Prints one JSON line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import shutil
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]

COUNTERS = """
__device__ unsigned long long g_clk[10];
#define ATM_CLK(k) do { if (threadIdx.x == 0) { \\
  const unsigned long long t_ = clock64(); \\
  atomicAdd(&g_clk[k], t_ - clk0_); clk0_ = t_; } } while (0)
"""
READ_BACK = """
extern "C" int atm_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, atm::g_clk, sizeof(atm::g_clk));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(atm::g_clk, z, sizeof(z));
}
"""
# (old, new) pairs per layout; each old text must occur exactly once.
LOCKSTEP = [
    ("""  for (int it = 1; it <= a.max_iter; ++it) {
    const bool is_last""", """  unsigned long long clk0_ = clock64();
  for (int it = 1; it <= a.max_iter; ++it) {
    if (threadIdx.x == 0) atomicAdd(&g_clk[7], 1ull);
    const bool is_last"""),
    ("""                         is_last ? Uout : nullptr, Xout);
    __syncthreads();
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      finish_stage(a, s, is_check, record);
      __syncthreads();
    }
    if (decide_stage<ADAPTIVE>(a, s, it, is_check, record)) break;
    backward_stage(a, s);
    __syncthreads();
  }""", """                         is_last ? Uout : nullptr, Xout);
    __syncthreads();
    ATM_CLK(0);
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      ATM_CLK(1);
      finish_stage(a, s, is_check, record);
      __syncthreads();
      ATM_CLK(2);
    }
    if (decide_stage<ADAPTIVE>(a, s, it, is_check, record)) break;
    backward_stage(a, s);
    __syncthreads();
    ATM_CLK(3);
  }"""),
]
SLOTS = [
    ("""  int live = refill_stage<ADAPTIVE, ROLLOUT>(a, s, a.d.tile, true);
  while (live > 0) {
    forward_stage<CONES, ROLLOUT>(a, s);
    __syncthreads();
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      finish_stage(a, s);
      __syncthreads();
    }""", """  int live = refill_stage<ADAPTIVE, ROLLOUT>(a, s, a.d.tile, true);
  unsigned long long clk0_ = clock64();
  while (live > 0) {
    if (threadIdx.x == 0) atomicAdd(&g_clk[7], 1ull);
    forward_stage<CONES, ROLLOUT>(a, s);
    __syncthreads();
    ATM_CLK(0);
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      ATM_CLK(1);
      finish_stage(a, s);
      __syncthreads();
      ATM_CLK(2);
    }"""),
    ("""    const int nret = *s.nref;   // slots waiting to be retired
    if""", """    ATM_CLK(3);
    const int nret = *s.nref;   // slots waiting to be retired
    if"""),
    ("""      s.done[threadIdx.x] = DONE;   // it waits for a refill; the next
    }                               // forward stage's barrier orders this
  }""", """      s.done[threadIdx.x] = DONE;   // it waits for a refill; the next
    }                               // forward stage's barrier orders this
    ATM_CLK(4);
  }"""),
    ("""    if (!initial) retire_slot<ROLLOUT>(a, s, i);
    __syncwarp();   // every lane is done with the slot's old state""",
     """    unsigned long long c0_ = clock64();
    if (!initial) retire_slot<ROLLOUT>(a, s, i);
    __syncwarp();   // every lane is done with the slot's old state
    unsigned long long c1_ = clock64();"""),
    ("""    load_slot<ADAPTIVE, ROLLOUT>(a, s, i);
  }
  __syncthreads();   // the loads' done flags""",
     """    load_slot<ADAPTIVE, ROLLOUT>(a, s, i);
    __syncwarp();
    if (lane == 0 && !initial) {
      const unsigned long long c2_ = clock64();
      atomicAdd(&g_clk[5], c1_ - c0_);
      atomicAdd(&g_clk[6], c2_ - c1_);
      atomicAdd(&g_clk[8], 1ull);
    }
  }
  __syncthreads();   // the loads' done flags"""),
]


# The slot kernels templated over the operators' placement name the
# template parameter in every stage call.
PLACED = ("refill_stage<ADAPTIVE, ROLLOUT", "forward_stage<CONES, ROLLOUT",
          "retire_slot<ROLLOUT", "load_slot<ADAPTIVE, ROLLOUT")


def _placed(text: str, tiled: bool = False) -> str:
    for call in PLACED:
        text = text.replace(call + ">", call + ", GOPS>")
    if tiled:   # templated over the register tile's slots too
        text = text.replace("forward_stage<CONES", "forward_stage<RI, CONES")
    return text


def instrumented_copy(root: pathlib.Path, dst: pathlib.Path) -> str:
    pkg = dst / "accelerated_tinympc_tpu_torch"
    shutil.copytree(root / "accelerated_tinympc_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = pkg / "ops" / "csrc" / "admm_iteration.cuh"
    src = cuh.read_text()
    layout, edits = ("slots", SLOTS) if "run_block" in src else (
        "lockstep", LOCKSTEP)
    if "bool GOPS" in src:
        tiled = "template <int RI, bool ADAPTIVE" in src
        layout = "slots over two placements" + (
            " and two register tiles" if tiled else "")
        edits = [(_placed(old, tiled), _placed(new, tiled))
                 for old, new in SLOTS]
    src = src.replace("namespace atm {\n", "namespace atm {\n" + COUNTERS, 1)
    for old, new in edits:
        if src.count(old) != 1:
            sys.exit(f"{cuh}: the {layout} layout's text is not found once:"
                     f"\n{old}")
        src = src.replace(old, new)
    cuh.write_text(src)
    cu = pkg / "ops" / "csrc" / "fused_admm.cu"
    cu.write_text(cu.read_text() + READ_BACK)
    return layout


def main():
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's workloads and timer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_stage_clocks_"))
    try:
        layout = instrumented_copy(root, tmp)
        os.environ["ATM_TORCH_BUILD_DIR"] = str(tmp / "build")
        sys.path.insert(0, str(tmp))
        import torch

        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        from accelerated_tinympc_tpu_torch.ops import (
            FusedCarry, fused_admm, fused_solve, pad_cones,
        )

        lib = fused_admm._library()
        buf = (ctypes.c_ulonglong * 10)()

        def measure(fn):
            fn()
            torch.cuda.synchronize()
            assert lib.atm_clocks(buf) == 0   # read and zero
            ms = cs.cuda_ms(fn, 1)            # a warm-up and a timed call
            assert lib.atm_clocks(buf) == 0
            v = list(buf)
            it, slots = max(v[7], 1), max(v[8], 1)
            return {"ms": ms, "block_iters": v[7] / 2,
                    "cycles_per_block_iter": dict(zip(
                        ("forward", "cone", "finish", "decide_backward",
                         "refill"), (round(x / it, 1) for x in v[:5]))),
                    "retire_cycles_per_slot": round(v[5] / slots, 1),
                    "load_cycles_per_slot": round(v[6] / slots, 1)}

        B, dev = cs.MAIN_BATCH, "cuda"
        problem, _c, pp, x0s = cs.flagship(B, dev)
        cold = FusedCarry.zeros(B, pp, device=dev)
        x1, warm = cs.warm_start(problem, pp, x0s, dev)
        _lp, _lc, lpp, lx = cs.lander(B, dev)
        lcold = FusedCarry.zeros(B, lpp, device=dev)
        cops = pad_cones(lpp, cs.lander_cones())
        row = {"root": str(root), "layout": layout,
               "K1": measure(lambda: fused_solve(x0s, cold, pp, max_iter=100)),
               "K2": measure(lambda: fused_solve(x1, warm, pp, **cs.WARM_KW)),
               "lander_box_fixed": measure(lambda: fused_solve(
                   lx, lcold, lpp, **cs.LANDER_FIXED)),
               "K4a": measure(lambda: fused_solve(
                   lx, lcold, lpp, cone_ops=cops, **cs.LANDER_FIXED)),
               "K4b": measure(lambda: fused_solve(
                   lx, lcold, lpp, cone_ops=cops, **cs.LANDER_ADAPTIVE))}
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
