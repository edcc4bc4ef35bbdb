#!/usr/bin/env python3
"""Cycles per knot step of the long-horizon kernels (K9-K12) on one GPU,
split by stage, from clock counters put into a copy of a checkout's
``ops/csrc/stream_admm.cu`` and ``stream_shared.cu``.

    python3 tools/torch_stream_stage_clocks.py [ROOT] [--batches 512 8192]

ROOT holds ``accelerated_tinympc_tpu_torch`` (default: this checkout). The
profilers that would split a kernel's time by stage (``ncu``) may not run
where the card is, so the script copies ROOT's package into a temporary
directory and adds counters to the copy. In the lane-group kernel of
earlier checkouts (``stream_kernel``): at every knot step of both sweeps,
lane 0 of the block's first group reads ``clock64()`` before the knot's
loads from device memory, once they have arrived (an empty ``asm`` that
uses them orders the read), around the cone projections and at the end of
the step; per
iteration, around the whole iteration; and once around the end of the
kernel (the adaptive kernel's copy of the scratch slacks). The loads are
issued at the top of the step, where the kernel issues them anyway (the
compiler cannot hoist them above the previous step's stores).

What it reports, per knot step, in cycles: ``fwd_load`` (waiting for g, d,
y), ``fwd_cones``, ``fwd_rest`` (the chain u = -K x - d -> x+ = A x + B u
with its shuffles, the clips and the stores), split between iterations
without residuals and with them (the check iterations of the adaptive
kernel, the last one of the fixed kernel), ``bwd_load`` (z, y, qc, v, g) and
``bwd_rest``; per iteration, the cycles outside the two sweeps'
knot steps (``per_iter_extra``: the loop's ``__any_sync``, parity
bookkeeping, the terminal costate); per block, ``tail`` (the final copy of
the scratch slacks). The counters cost a few instructions per step, so the
times printed beside them are above the uninstrumented kernels'.

Kernels measured: the shared-plant K9/K10 where ROOT's ``stream_solve``
still runs the lane-group kernel (before ``csrc/stream_shared.cu``), and
the per-instance-plant K11/K12 (``hstream_solve``) in every checkout.
Where ROOT has ``csrc/stream_shared.cu`` (a thread per instance), its
K9/K10 get counters too, read by lane 0 of each one-warp block: per knot
of a sweep, the cycles issuing the next knot's cp.async copies
(``*_issue``), waiting for this knot's (``*_wait``) and computing with the
direct stores (``*_compute``); ``shared_K9_b*``/``shared_K10_b*``. The
workloads are ``chip_smoke.py``'s for K9/K10 (the long-horizon example's
plant, nx=8, nu=3, N=1024, x0 of three scales; fixed 100 iterations, and
check 5 at tolerance 1e-3) and, for K11/K12, the same plant at N=256 given
to every instance. K11/K12 are also clocked on ``chip_smoke.py``'s timed
workload (the robust family, seed 12, nx=12, nu=4, N=256, 8,192 instances;
fixed 100 and check 5: ``K11_timed``, ``K12_timed``), beside each
instantiation's registers per thread (``-Xptxas -v`` of an uninstrumented
build of ROOT's ``stream_admm.cu``), the blocks an SM holds at once (the
CUDA occupancy query) and the waves that launch takes.

Where ROOT's ``stream_admm.cu`` is the hstream kernel of register rows and
a knot ring (its stage hooks ``ATM_CLK``, empty unless defined), the
counters split each knot of each sweep into issuing the ring's copies
(``*_issue``), waiting for the knot and the group's barrier (``*_wait``)
and computing with the direct stores (``*_compute``), read by thread 0 of
every block; ``per_iter_extra`` is the rest of an iteration (the first
copies of each sweep, the residuals' reduction, the bookkeeping).

Prints one JSON line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[1]
NCLK = 14

COUNTERS = f"""
__device__ unsigned long long g_clk[{NCLK}];
__shared__ unsigned long long s_clk_[{NCLK}];
#define ATM_ADD(k, v) do {{ if (threadIdx.x == 0) s_clk_[k] += (v); }} while (0)
"""
READ_BACK = f"""
extern "C" int atm_clocks(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, atm_stream::g_clk,
                                       sizeof(atm_stream::g_clk));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{NCLK}] = {{0}};
  return (int)cudaMemcpyToSymbol(atm_stream::g_clk, z, sizeof(z));
}}
"""
# Counters: 0 fwd load, 1 fwd cones, 2 fwd step (no residuals), 3 bwd load,
# 4 bwd step, 5 fwd steps, 6 bwd steps, 7 iteration, 8 tail, 9 iterations,
# 10 blocks, 11 fwd step with residuals, 12 its steps, 13 fwd load on those.
EDITS = [
    ("""    const int ex = i * nx + lane;
    const float tx = xi + (lx ? s.Gd[ex] : 0.0f);""",
     """    const int ex = i * nx + lane;
    const unsigned long long k0_ = clock64();
    const float gx_ = lx ? s.Gd[ex] : 0.0f;
    const float dd_ = (i < m && lu) ? s.D[i * nu + lane] : 0.0f;
    const float yy_ = (i < m && lu) ? s.Y[i * nu + lane] : 0.0f;
    asm volatile("" ::"f"(gx_), "f"(dd_), "f"(yy_));
    ATM_ADD(res ? 13 : 0, clock64() - k0_);
    const float tx = xi + gx_;"""),
    ("(lu ? s.D[eu] : 0.0f)", "dd_"),
    ("(lu ? s.Y[eu] : 0.0f)", "yy_"),
    ("""    xi = dot<G>(s.Ar, xi) + dot<G>(s.Br, u);
  }""", """    xi = dot<G>(s.Ar, xi) + dot<G>(s.Br, u);
    asm volatile("" ::"f"(xi));
    ATM_ADD(res ? 11 : 2, clock64() - k0_);
    ATM_ADD(res ? 12 : 5, 1ull);
  }"""),
    ("""    const int eu = i * nu + lane;
    const float r = lu ? -s.rho * (Zn[eu] - s.Y[eu]) : 0.0f;""",
     """    const int eu = i * nu + lane;
    const unsigned long long k0_ = clock64();
    const float zz_ = lu ? Zn[eu] : 0.0f, yb_ = lu ? s.Y[eu] : 0.0f;
    const int e_ = i * nx + lane;
    const bool q_ = i > 0 && lx;
    const float qq_ = q_ ? s.Qc[e_] : 0.0f, vv_ = q_ ? Vn[e_] : 0.0f;
    const float gg_ = q_ ? s.Gd[e_] : 0.0f;
    asm volatile("" ::"f"(zz_), "f"(yb_), "f"(qq_), "f"(vv_), "f"(gg_));
    ATM_ADD(3, clock64() - k0_);
    const float r = lu ? -s.rho * (zz_ - yb_) : 0.0f;"""),
    ("const float q = lx ? s.Qc[e] - s.rho * (Vn[e] - s.Gd[e]) : 0.0f;",
     "const float q = lx ? qq_ - s.rho * (vv_ - gg_) : 0.0f;"),
    ("""      p = q + dot<G>(s.Mr, p) - dot<G>(s.Ktr, r);
    }
  }""", """      p = q + dot<G>(s.Mr, p) - dot<G>(s.Ktr, r);
    }
    asm volatile("" ::"f"(p));
    ATM_ADD(4, clock64() - k0_);
    ATM_ADD(6, 1ull);
  }"""),
    ("""  const int lane = threadIdx.x & (G - 1);""",
     """  const int lane = threadIdx.x & (G - 1);
  if (threadIdx.x == 0)
    for (int k_ = 0; k_ < %d; ++k_) s_clk_[k_] = 0ull;""" % NCLK),
    ("""      const bool last = it == a.max_iter - 1;""",
     """      const unsigned long long it0_ = clock64();
      const bool last = it == a.max_iter - 1;"""),
    ("""      backward<G>(a, s, lane, 0, valid);
    }""", """      backward<G>(a, s, lane, 0, valid);
      ATM_ADD(7, clock64() - it0_);
      ATM_ADD(9, 1ull);
    }"""),
    ("""      const int kc = k + 1;""", """      const unsigned long long it0_ = clock64();
      const int kc = k + 1;"""),
    ("""        solved = 1.0f;
      }
    }
  }""", """        solved = 1.0f;
      }
      ATM_ADD(7, clock64() - it0_);
      ATM_ADD(9, 1ull);
    }
  }"""),
    ("""  if (!valid) return;""", """  const unsigned long long t0_ = clock64();
  if (!valid) return;"""),
    ("""    st[6] = 0.0f; st[7] = 0.0f;
  }
}""", """    st[6] = 0.0f; st[7] = 0.0f;
  }
  ATM_ADD(8, clock64() - t0_);
  ATM_ADD(10, 1ull);
  if (threadIdx.x == 0)
    for (int k_ = 0; k_ < %d; ++k_) atomicAdd(&g_clk[k_], s_clk_[k_]);
}""" % NCLK),
]


SHARED_COUNTERS = """
__device__ unsigned long long g_clks[10];
#define CLKS(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) { ck_[k] += t_ - c0_; } c0_ = t_; } while (0)
"""
SHARED_READ_BACK = """
extern "C" int atm_shared_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, atm_shared::g_clks,
                                       sizeof(atm_shared::g_clks));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(atm_shared::g_clks, z, sizeof(z));
}
"""
# Counters: 0 fwd before the issue, 1 fwd issue, 2 fwd wait, 3 fwd compute,
# 4 bwd issue (and the loop top), 5 bwd wait, 6 bwd compute, 7 bookkeeping,
# 8 fwd knots, 9 bwd knots.
SHARED_EDITS = [
    ("""  while (__any_sync(FULL, b >= 0)) {""",
     """  unsigned long long ck_[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  unsigned long long c0_ = clock64();
  while (__any_sync(FULL, b >= 0)) {"""),
    ("""        if (ia <= m)
          fetch_forward(a, L, ring + (ia % kb) * ew, ia, b, full, res);
        cp_commit();
        cp_wait(kb - 1);                   // knot i has arrived""",
     """        CLKS(0);
        if (ia <= m)
          fetch_forward(a, L, ring + (ia % kb) * ew, ia, b, full, res);
        cp_commit();
        CLKS(1);
        cp_wait(kb - 1);                   // knot i has arrived
        { const float e_ = ring[(i % kb) * ew]; asm volatile("" ::"f"(e_)); }
        CLKS(2);"""),
    ("""          for (int c = 0; c < NX; ++c) x[c] = xn[c];
        } else {""", """          for (int c = 0; c < NX; ++c) x[c] = xn[c];
          asm volatile("" ::"f"(x[0]));
          CLKS(3);
          ++ck_[8];
        } else {"""),
    ("""          fetch_backward(a, L, ring + (ta % kb) * ew, m - ta, b, chk);
          cp_commit();
          cp_wait(kb - 1);""", """          fetch_backward(a, L, ring + (ta % kb) * ew, m - ta, b, chk);
          cp_commit();
          CLKS(4);
          cp_wait(kb - 1);
          { const float e_ = ring[(t % kb) * ew]; asm volatile("" ::"f"(e_)); }
          CLKS(5);"""),
    ("""#pragma unroll
              for (int c = 0; c < NX; ++c) p[c] = pn[c];""", """#pragma unroll
              for (int c = 0; c < NX; ++c) p[c] = pn[c];
              asm volatile("" ::"f"(p[0]));
              CLKS(6);
              ++ck_[9];"""),
    ("""    // --------------------------------------------- iteration bookkeeping""",
     """    CLKS(7);
    // --------------------------------------------- iteration bookkeeping"""),
    ("""        b = first + __popc(want & ((1u << lane) - 1u));
        if (b >= Bn) b = -1;
      }
    }
  }
}""", """        b = first + __popc(want & ((1u << lane) - 1u));
        if (b >= Bn) b = -1;
      }
    }
  }
  if (threadIdx.x == 0)
    for (int k = 0; k < 10; ++k) atomicAdd(&g_clks[k], ck_[k]);
}"""),
]


# The hstream kernel with stage hooks: ATM_CLK(k) adds the cycles since the
# last mark to counter k, ATM_CLK_COUNT(k) counts; thread 0 of each block
# keeps them in shared memory and adds them to g_clkh at the end. Counters:
# 0 fwd issue, 1 fwd wait, 2 fwd compute, 3 bwd issue, 4 bwd wait, 5 bwd
# compute, 6 the rest of an iteration, 7 fwd knots, 8 bwd knots, 9
# iterations, 10 blocks.
HOOK_DEFS = """
#include <cuda_runtime.h>
namespace atm_stream { __device__ unsigned long long g_clkh[11]; }
#define ATM_CLK_BEGIN() __shared__ unsigned long long s_ck_[11]; \\
  if (threadIdx.x == 0) for (int k_ = 0; k_ < 11; ++k_) s_ck_[k_] = 0ull; \\
  unsigned long long c0_ = clock64()
#define ATM_CLK(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) s_ck_[k] += t_ - c0_; c0_ = t_; } while (0)
#define ATM_CLK_COUNT(k) do { if (threadIdx.x == 0) ++s_ck_[k]; } while (0)
#define ATM_CLK_END() do { if (threadIdx.x == 0) { s_ck_[10] = 1; \\
  for (int k_ = 0; k_ < 11; ++k_) \\
    atomicAdd(&atm_stream::g_clkh[k_], s_ck_[k_]); } } while (0)
"""
HOOK_READ_BACK = """
extern "C" int atm_hstream_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, atm_stream::g_clkh,
                                       sizeof(atm_stream::g_clkh));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[11] = {0};
  return (int)cudaMemcpyToSymbol(atm_stream::g_clkh, z, sizeof(z));
}
"""
# Blocks an SM holds at once, for the lane-group kernel (G = 16: the timed
# 12/4 shape), appended to an uninstrumented copy; the hstream kernel of
# register rows has its own query (atm_hstream_resident).
LANE_GROUP_PROBE = """
extern "C" int atm_probe_resident(int adaptive) {
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, adaptive ? atm_stream::stream_kernel<16, true, false>
                   : atm_stream::stream_kernel<16, false, false>,
      atm_stream::THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}
"""


def lane_group(src: str) -> bool:
    """Whether a stream_admm.cu is the lane-group kernel (before the
    hstream kernel of register rows)."""
    return "struct Inst" in src


def load_build(pkg: pathlib.Path):
    """A package's ``ops/_build.py``, loaded from its file (importing the
    package itself would fix which copy ``accelerated_tinympc_tpu_torch``
    names)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"atm_build_{abs(hash(str(pkg)))}", pkg / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvcc_build(cu: pathlib.Path, out: pathlib.Path) -> str:
    """Compile one source into a shared library with this checkout's flags;
    returns the compiler's output."""
    _build = load_build(HERE / "accelerated_tinympc_tpu_torch")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(cu.parent), "-o",
           str(out), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {cu}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def prebuild(pkg: pathlib.Path, names) -> None:
    """Build a copy's libraries of ``names`` where its loader looks for them
    (only those: the fused sources take minutes)."""
    mod = load_build(pkg)
    mod.build_dir().mkdir(parents=True, exist_ok=True)
    for name in names:
        cu = pkg / "ops" / "csrc" / f"{name}.cu"
        if cu.exists():
            log = nvcc_build(cu, mod.library_path(name))
            mod.library_path(name).with_suffix(".log").write_text(log)


def instrument_shared(cu: pathlib.Path) -> None:
    """Counters in a copy of stream_shared.cu (its compiled 8/3 body only)."""
    src = cu.read_text()
    src = src.replace("namespace atm_shared {\n",
                      "namespace atm_shared {\n" + SHARED_COUNTERS, 1)
    for old, new in SHARED_EDITS:
        if src.count(old) != 1:
            sys.exit(f"{cu}: text not found once:\n{old}")
        src = src.replace(old, new)
    cu.write_text(src + SHARED_READ_BACK)


def instrumented_copy(root: pathlib.Path, dst: pathlib.Path) -> bool:
    """Copy ROOT's package to dst with counters in stream_admm.cu; returns
    whether the copy's stream_solve runs the lane-group kernel (K9/K10)."""
    pkg = dst / "accelerated_tinympc_tpu_torch"
    shutil.copytree(root / "accelerated_tinympc_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "ops" / "csrc" / "stream_admm.cu"
    src = cu.read_text()
    shared = pkg / "ops" / "csrc" / "stream_shared.cu"
    if shared.exists():
        instrument_shared(shared)
    if not lane_group(src):        # the hooks of the register-row kernel
        cu.write_text(HOOK_DEFS + src + HOOK_READ_BACK)
        return False
    src = src.replace("namespace atm_stream {\n",
                      "namespace atm_stream {\n" + COUNTERS, 1)
    for old, new in EDITS:
        if src.count(old) != 1:
            sys.exit(f"{cu}: text not found once:\n{old}")
        src = src.replace(old, new)
    # around the cone calls of the forward sweep (counter 1)
    pat = re.compile(
        r"(    if \((?:CONES && )?a\.nc_([ux])\)\s*(vn|zn) = cones<G>\([^;]*;)")
    if len(pat.findall(src)) != 2:
        sys.exit(f"{cu}: the two cone calls are not found")
    src = pat.sub(lambda mt: (
        "    const unsigned long long c%s_ = clock64();\n%s\n"
        "    asm volatile(\"\" ::\"f\"(%s));\n"
        "    ATM_ADD(1, clock64() - c%s_);") % (
            mt.group(2), mt.group(1), mt.group(3), mt.group(2)), src)
    cu.write_text(src + READ_BACK)
    return not shared.exists()


def registers_and_occupancy(root: pathlib.Path, tmp: pathlib.Path,
                            plan_new) -> dict:
    """Registers per thread of each stream_kernel instantiation (an
    uninstrumented build of ROOT's source) and, for the timed 12/4 shape,
    the blocks an SM holds at once in each mode."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    cu = root / "accelerated_tinympc_tpu_torch" / "ops" / "csrc" / \
        "stream_admm.cu"
    src = cu.read_text()
    probe = tmp / "probe"
    probe.mkdir(exist_ok=True)
    for hdr in cu.parent.glob("*.cuh"):
        shutil.copy(hdr, probe / hdr.name)
    copy = probe / "stream_admm.cu"
    old = lane_group(src)
    copy.write_text(src + (LANE_GROUP_PROBE if old else ""))
    log = nvcc_build(copy, probe / "libprobe.so")
    out = {"ptxas": [r for r in cs.ptxas_per_kernel(log)
                     if "stream_kernel" in r["kernel"]]}
    lib = ctypes.CDLL(str(probe / "libprobe.so"))
    if old:
        out["resident_blocks_per_sm"] = {
            mode: lib.atm_probe_resident(ad)
            for mode, ad in (("fixed", 0), ("adaptive", 1))}
        out["threads_per_block"] = 128
        out["instances_per_block"] = 8
    else:
        plan = plan_new()
        lib.atm_hstream_resident.argtypes = [ctypes.c_int] * 7
        out["plan"] = plan
        out["resident_blocks_per_sm"] = {
            mode: lib.atm_hstream_resident(12, 4, plan["kb"], 0, 0, ad,
                                           plan["threads"])
            for mode, ad in (("fixed", 0), ("adaptive", 1))}
        out["threads_per_block"] = plan["threads"]
        out["instances_per_block"] = plan["instances_per_block"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--batches", type=int, nargs="+", default=[512, 8192])
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs   # this checkout's timer
    sys.path.insert(0, str(HERE / "tools"))
    import torch_stream_times as tst   # the timed workloads

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="atm_stream_clocks_"))
    try:
        group_k9 = instrumented_copy(root, tmp)
        os.environ["ATM_TORCH_BUILD_DIR"] = str(tmp / "build")
        pkg = tmp / "accelerated_tinympc_tpu_torch"
        prebuild(pkg, ("stream_admm", "stream_shared"))
        sys.path.insert(0, str(tmp))
        import numpy as np
        import torch

        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        import accelerated_tinympc_tpu_torch as atm
        from accelerated_tinympc_tpu_torch.ops import hstream_admm as hs
        from accelerated_tinympc_tpu_torch.ops import stream_admm as sa

        assert pathlib.Path(atm.__file__).resolve().is_relative_to(tmp)
        lib = sa._library() if group_k9 else sa._library("stream_admm")
        old = lane_group((pkg / "ops" / "csrc" / "stream_admm.cu")
                         .read_text())
        dev = "cuda"
        per = lambda a, n: round(a / max(n, 1), 1)

        def measure(fn):
            """Stage cycles of the lane-group kernel (counters above)."""
            lib.atm_clocks.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * NCLK)()
            fn()
            torch.cuda.synchronize()
            assert lib.atm_clocks(ctypes.addressof(buf)) == 0  # read, zero
            ms = cs.cuda_ms(fn, 1)            # a warm-up and a timed call
            assert lib.atm_clocks(ctypes.addressof(buf)) == 0
            v = [x / 2 for x in buf]          # two calls
            steps = v[5] + v[12]
            sweeps = v[2] + v[11] + v[4]
            return {
                "ms": ms, "iterations_per_block": per(v[9], v[10]),
                "fwd_load": per(v[0], v[5]), "fwd_cones": per(v[1], steps),
                "fwd_rest": per(v[2] - v[0], v[5]) if v[5] else None,
                "fwd_load_with_residuals": per(v[13], v[12]),
                "fwd_rest_with_residuals": (
                    per(v[11] - v[13], v[12]) if v[12] else None),
                "bwd_load": per(v[3], v[6]), "bwd_rest": per(v[4] - v[3],
                                                             v[6]),
                "per_iter_extra": per(v[7] - sweeps, v[9]),
                "iter_cycles": per(v[7], v[9]),
                "tail_per_block": per(v[8], v[10])}

        def measure_hooks(fn):
            """Stage cycles of the register-row kernel (its hooks)."""
            lib.atm_hstream_clocks.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * 11)()
            fn()
            torch.cuda.synchronize()
            assert lib.atm_hstream_clocks(ctypes.addressof(buf)) == 0
            ms = cs.cuda_ms(fn, 1)
            assert lib.atm_hstream_clocks(ctypes.addressof(buf)) == 0
            v = [x / 2 for x in buf]
            sweeps = sum(v[0:6])
            return {
                "ms": ms, "iterations_per_block": per(v[9], v[10]),
                "fwd_issue": per(v[0], v[7]), "fwd_wait": per(v[1], v[7]),
                "fwd_compute": per(v[2], v[7]),
                "bwd_issue": per(v[3], v[8]), "bwd_wait": per(v[4], v[8]),
                "bwd_compute": per(v[5], v[8]),
                "per_iter_extra": per(v[6], v[9]),
                "iter_cycles": per(sweeps + v[6], v[9])}

        hmeasure = measure if old else measure_hooks

        def plant(N):
            prob, rho = atm.models.random_lti_problem(0, 8, 3, N, device=dev)
            cch = atm.riccati_cache(prob.A, prob.B, prob.Q, prob.R, rho,
                                    device=dev)
            return prob, cch, rho

        def x0_of(batch):
            rng = np.random.default_rng(11)
            sc = np.resize(np.asarray((0.3, 3.0, 10.0)), batch)[:, None]
            return torch.as_tensor(sc * rng.standard_normal((batch, 8)),
                                   dtype=torch.float32, device=dev)

        adapt5 = dict(max_iter=100, check_termination=5, abs_pri_tol=1e-3,
                      abs_dua_tol=1e-3)
        row = {"root": str(root), "lane_group_K9_K10": group_k9,
               "lane_group_K11_K12": old,
               "device": torch.cuda.get_device_name(0)}
        prob, cch, rho = plant(1024)
        sp = sa.pad_stream_problem(prob, cch)
        prob256, _c, _r = plant(256)

        def measure_shared(fn):
            slib = sa._library("stream_shared")
            slib.atm_shared_clocks.argtypes = [ctypes.c_void_p]
            sbuf = (ctypes.c_ulonglong * 10)()
            fn()
            torch.cuda.synchronize()
            assert slib.atm_shared_clocks(ctypes.addressof(sbuf)) == 0
            ms = cs.cuda_ms(fn, 1)
            assert slib.atm_shared_clocks(ctypes.addressof(sbuf)) == 0
            v = list(sbuf)
            return {"ms": ms, "fwd_issue": per(v[0] + v[1], v[8]),
                    "fwd_wait": per(v[2], v[8]),
                    "fwd_compute": per(v[3], v[8]),
                    "bwd_issue": per(v[4], v[9]), "bwd_wait": per(v[5], v[9]),
                    "bwd_compute": per(v[6], v[9])}

        for Bn in args.batches:
            x0 = x0_of(Bn)
            if not group_k9:
                cold = sa.StreamCarry.zeros(Bn, sp)
                row[f"shared_K9_b{Bn}"] = measure_shared(
                    lambda: sa.stream_solve(x0, cold, sp, max_iter=100))
                row[f"shared_K10_b{Bn}"] = measure_shared(
                    lambda: sa.stream_solve(x0, cold, sp, **adapt5))
            if group_k9:
                cold = sa.StreamCarry.zeros(Bn, sp)
                row[f"K9_b{Bn}"] = measure(lambda: sa.stream_solve(
                    x0, cold, sp, max_iter=100))
                row[f"K10_b{Bn}"] = measure(lambda: sa.stream_solve(
                    x0, cold, sp, **adapt5))
            rep = lambda a: a[None].expand(Bn, *a.shape).contiguous()
            pb = prob256.replace(**{k: rep(getattr(prob256, k)) for k in (
                "A", "B", "Q", "R", "u_min", "u_max", "x_min", "x_max",
                "Xref", "Uref")})
            hsp = hs.pad_hstream_from_plants(pb.A, pb.B, pb.Q, pb.R,
                                             torch.full((Bn,), float(rho),
                                                        device=dev), pb)[0]
            hcold = sa.StreamCarry.zeros(Bn, hsp)
            row[f"K11_b{Bn}"] = hmeasure(lambda: hs.hstream_solve(
                x0, hcold, hsp, max_iter=100))
            row[f"K12_b{Bn}"] = hmeasure(lambda: hs.hstream_solve(
                x0, hcold, hsp, **adapt5))
            del x0, hsp, hcold
        # K11/K12 on chip_smoke.py's timed workload (12/4/256 at 8,192)
        hsp, x0_f, hcold = tst.hstream_workload(atm)
        row["K11_timed"] = hmeasure(lambda: hs.hstream_solve(
            x0_f, hcold, hsp, max_iter=100))
        row["K12_timed"] = hmeasure(lambda: hs.hstream_solve(
            x0_f, hcold, hsp, **adapt5))
        row["K12_timed"]["iters_mean"] = float(hs.hstream_solve(
            x0_f, hcold, hsp, **adapt5).stats[:, 0].mean())

        geo = registers_and_occupancy(
            root, tmp, lambda: sa.hstream_plan(12, 4, 256))
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = -(-8192 // geo["instances_per_block"])
        geo["waves_b8192"] = {
            mode: -(-blocks // (n * n_sm)) if n > 0 else None
            for mode, n in geo["resident_blocks_per_sm"].items()}
        row["K11_K12_geometry_12_4"] = geo
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
