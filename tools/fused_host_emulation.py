#!/usr/bin/env python3
"""K1's two bodies (the fixed box-only float32 solve), emulated on the CPU
from their CUDA sources, held bit for bit against each other and against
another checkout's.

    python3 tools/fused_host_emulation.py [ROOT] [--against ROOT_A]

Compiles ROOT's ``csrc/fused_admm.cu`` (the float32 fused kernels) for the
host with g++, on an emulation of the CUDA subset the kernels use (the
header below): a std::thread per CUDA thread, std::barrier for
``__syncthreads`` and for each warp's collectives (shuffles, votes,
reductions; every lane of a warp reaches each together, as the kernels'
warp-uniform code does), the blocks of a grid one after another on shared
memory filled with NaN, 3 SMs. FMAs are the C library's ``fmaf`` (one
rounding, as the card's FFMA) and nothing else is contracted, so the
emulation holds the order of every sum, not what nvcc contracts (an
``a * b + c`` the card may fuse). K1 then runs through ROOT's own wrapper
(``ops.fused_admm._launch_solve`` on CPU tensors) at small cases, each on
K1's own body and on the shared slot body (``FIXED_WAVES``): 200
quadrotors at 48 slots on 3 blocks (several waves a block), 37 at 8 slots,
77 at 32, 50 with the operators read from device memory, and N=18 at 8
slots; warm carries, 30 iterations. ``--against`` runs ROOT_A's kernels on
the same inputs (a checkout without ``FIXED_WAVES`` runs its one body).
Prints one JSON line: per case the path, whether the two bodies agree bit
for bit (and with ROOT_A's), and the largest difference from the plain
version. About a minute a checkout; needs g++ (C++20), no GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]

HEADER = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(a, b)
#define ATM_ASM(...) ((void)0)
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
struct dim3i { unsigned x, y, z; };
inline thread_local dim3i threadIdx, blockIdx;
inline dim3i blockDim, gridDim;
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }

struct EmuBlock {
  int nt;
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<uint64_t> xch;   // a word a thread
  explicit EmuBlock(int n) : nt(n), bar(n), xch(n) {
    for (int w = 0; w < n / 32; ++w)
      wbar.emplace_back(std::make_unique<std::barrier<>>(32));
  }
};
inline thread_local EmuBlock* tl_blk;
inline void __syncthreads() { tl_blk->bar.arrive_and_wait(); }
inline int __syncthreads_count(int p) {
  EmuBlock* b = tl_blk;
  b->bar.arrive_and_wait();
  b->xch[threadIdx.x] = p != 0;
  b->bar.arrive_and_wait();
  int s = 0;
  for (int i = 0; i < b->nt; ++i) s += (int)b->xch[i];
  b->bar.arrive_and_wait();
  return s;
}
inline void emu_warp_wait() { tl_blk->wbar[threadIdx.x >> 5]->arrive_and_wait(); }
inline void emu_warp_put(uint64_t v) {
  emu_warp_wait();
  tl_blk->xch[threadIdx.x] = v;
  emu_warp_wait();
}
inline uint64_t emu_lane(int l) { return tl_blk->xch[(threadIdx.x & ~31u) + l]; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_wait(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off, int = 32) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  emu_warp_put(u);
  const uint64_t r = emu_lane((threadIdx.x & 31) ^ off);
  emu_warp_wait();
  T o;
  std::memcpy(&o, &r, sizeof(T));
  return o;
}
template <class T, class F> inline T emu_reduce(unsigned mask, T v, T r, F f) {
  emu_warp_put((uint64_t)(uint32_t)v);
  for (int l = 0; l < 32; ++l)
    if ((mask >> l) & 1) r = f(r, (T)(uint32_t)emu_lane(l), l);
  emu_warp_wait();
  return r;
}
inline int __any_sync(unsigned m, int p) {
  return emu_reduce<int>(m, p != 0, 0, [](int r, int x, int) { return r | x; });
}
inline unsigned __reduce_or_sync(unsigned m, unsigned v) {
  return emu_reduce<unsigned>(m, v, 0u,
                              [](unsigned r, unsigned x, int) { return r | x; });
}
inline int __reduce_max_sync(unsigned m, int v) {
  return emu_reduce<int>(m, v, std::numeric_limits<int>::min(),
                         [](int r, int x, int) { return std::max(r, x); });
}
inline unsigned __match_any_sync(unsigned m, int v) {
  return emu_reduce<int>(m, v, 0, [v](int r, int x, int l) {
    return x == v ? (int)((unsigned)r | (1u << l)) : r;
  });
}
template <class T> inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <class T> inline T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T o = a.load();
  while (o < v && !a.compare_exchange_weak(o, v)) {}
  return o;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 1,
       cudaDevAttrMultiProcessorCount = 2 };
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
  *n = 1;
  return 0;
}
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 3; return 0; }
inline int cudaGetLastError() { return 0; }

inline thread_local float4* emu_smem;
template <class K, class A>
void emu_launch(K kernel, int blocks, int threads, int smem_bytes, A a) {
  blockDim = {(unsigned)threads, 1, 1};
  gridDim = {(unsigned)blocks, 1, 1};
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (int b = 0; b < blocks; ++b) {
    std::vector<float4> buf(smem_bytes / 16 + 1, float4{nan, nan, nan, nan});
    EmuBlock blk(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        tl_blk = &blk;
        emu_smem = buf.data();
        kernel(a);
        blk.bar.arrive_and_drop();
        blk.wbar[t >> 5]->arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
"""

BF16 = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat162 { unsigned short x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
inline float2 __bfloat1622float2(__nv_bfloat162) { return {}; }
"""

N_SM = 3
# (name, horizon, batch, launch keywords)
CASES = (("b200_t48", 10, 200, dict(batch_tile=48, threads=256)),
         ("b37_t8", 10, 37, dict(batch_tile=8, threads=128)),
         ("b77_t32", 10, 77, dict(batch_tile=32, threads=256)),
         ("b50_device", 10, 50, dict(batch_tile=16, threads=256,
                                     placement="device")),
         ("N18_t8", 18, 21, dict(batch_tile=8, threads=128)))


def build(root: pathlib.Path, work: pathlib.Path) -> pathlib.Path:
    """ROOT's float32 fused kernels compiled for the host emulation."""
    src = work / "src"
    shutil.copytree(root / "accelerated_tinympc_tpu_torch" / "ops" / "csrc",
                    src)
    (src / "cuda_runtime.h").write_text(HEADER)
    (src / "cuda_bf16.h").write_text(BF16)
    body = src / "admm_iteration.cuh"
    body.write_text(re.sub(r"\basm(\s+volatile)?\(", "ATM_ASM(",
                           body.read_text()))
    entry = src / "fused_entry.cuh"
    text = entry.read_text().replace("extern __shared__ float4 smem4[];",
                                     "#define smem4 emu_smem")
    entry.write_text(re.sub(
        r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(",
        r"emu_launch(\1, \2, \3, \4, ", text))
    lib = work / "libfused_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++20", "-O2", "-fPIC",
                    "-shared", "-pthread", "-ffp-contract=off", "-I", str(src),
                    "-o", str(lib), str(src / "fused_admm.cu")], check=True)
    return lib


WORKER = r"""
import contextlib, ctypes, sys, types
import numpy as np
import torch
root, lib_path, out, n_sm = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
cases = eval(sys.argv[5])
sys.path.insert(0, root)
import accelerated_tinympc_tpu_torch as atm
from accelerated_tinympc_tpu_torch.ops import fused_admm as fa
from accelerated_tinympc_tpu_torch.ops import FusedCarry, pad_problem

lib = ctypes.CDLL(lib_path)
lib.atm_fused_solve.argtypes = fa._SOLVE_ARGTYPES
lib.atm_fused_solve.restype = fa._I
fa._library = lambda algo="f32": lib
props = types.SimpleNamespace(multi_processor_count=n_sm,
                              shared_memory_per_block_optin=fa.SMEM_LIMIT_BYTES)
torch.cuda.get_device_properties = lambda d: props
torch.cuda.device = lambda d: contextlib.nullcontext()
torch.cuda.current_stream = lambda: types.SimpleNamespace(cuda_stream=None)
res = {}
for name, N, batch, kw in cases:
    problem, cache, x0 = atm.models.quadrotor_hovering_setup(horizon=N,
                                                             device="cpu")
    ops = atm.condensed_operators(cache, problem.A, problem.B, N,
                                  device="cpu")
    pp = pad_problem(problem, cache, ops, device="cpu")
    rng = np.random.default_rng(N + batch)
    x0s = torch.as_tensor(x0[None] + 0.05 * rng.standard_normal((batch, 12)),
                          dtype=torch.float32)
    warm = fa.fused_solve_plain(x0s, FusedCarry.zeros(batch, pp, device="cpu"),
                                pp, max_iter=5).carry
    want = fa.fused_solve_plain(x0s, warm, pp, max_iter=30)
    with torch.no_grad():
        const_d = fa.fold_const_d(pp)
    flags = (True, False) if hasattr(fa, "FIXED_WAVES") else (None,)
    for flag in flags:
        if flag is not None:
            fa.FIXED_WAVES = flag
        r = fa._launch_solve(
            x0s, warm, pp.W_f, pp.W_b, pp.W_x, const_d, pp.lo, pp.hi,
            pp.dims, pp.rho_f, max_iter=30, check_termination=0,
            warmup_iters=0, abs_pri_tol=1e-3, abs_dua_tol=1e-3, alpha=1.0,
            batch_tile=kw["batch_tile"], threads=kw["threads"],
            placement=kw.get("placement"), register_tile=None)
        tile, threads, _s, _p, ri = fa._geometry(
            pp.dims, batch, None, kw["batch_tile"], kw["threads"],
            placement=kw.get("placement"))
        path = fa.fixed_path(pp.dims, tile, threads, ri) if flag else "slots"
        res[(name, path)] = [r.U, r.X, r.stats, *r.carry]
        res[(name, path, "plain")] = max(
            float((a - b).abs().max())
            for a, b in zip((r.U, r.X, *r.carry), (want.U, want.X, *want.carry)))
torch.save(res, out)
"""


def run(root: pathlib.Path, lib: pathlib.Path, out: pathlib.Path) -> dict:
    import torch

    subprocess.run([sys.executable, "-c", WORKER, str(root), str(lib),
                    str(out), str(N_SM), repr(CASES)], check=True)
    return torch.load(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--against", default=None,
                    help="another checkout whose kernels run the same inputs")
    args = ap.parse_args()
    roots = [pathlib.Path(args.root).resolve()]
    if args.against:
        roots.append(pathlib.Path(args.against).resolve())
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_host_emulation_"))
    try:
        res = []
        for i, root in enumerate(roots):
            work = tmp / str(i)
            work.mkdir()
            res.append(run(root, build(root, work), work / "out.pt"))
        equal = lambda a, b: all(bool((x == y).all()) and x.shape == y.shape
                                 for x, y in zip(a, b))
        row = {"root": str(roots[0]), "against": args.against, "cases": {}}
        for name, _n, _b, _kw in CASES:
            paths = [p for (c, p, *rest) in res[0] if c == name and not rest]
            case = {"paths": paths,
                    "plain_max_abs_diff": {p: res[0][(name, p, "plain")]
                                           for p in paths}}
            if len(paths) == 2:
                case["bodies_bit_exact"] = equal(res[0][(name, paths[0])],
                                                 res[0][(name, paths[1])])
            if len(res) == 2:
                other = [k for k in res[1] if k[0] == name and len(k) == 2]
                case["against_bit_exact"] = all(
                    equal(res[0][(name, p)], res[1][o])
                    for p in paths for o in other)
            row["cases"][name] = case
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
