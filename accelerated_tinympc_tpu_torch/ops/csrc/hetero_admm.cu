// Heterogeneous-plant ADMM kernels for Hopper (sm_90a): a distinct plant and
// Riccati cache per instance, short horizons, FP32 (K7, K8).
//
//   hetero_kernel<NX, NU, false, *>  replaces accelerated_tinympc_tpu/ops/
//                                    hetero_admm.py _kernel (fixed
//                                    iterations; its _make_iteration, _dotb,
//                                    _apply_cones and _project_soc_seg
//                                    [_masked] helpers)
//   hetero_kernel<NX, NU, true, *>   replaces hetero_admm.py _kernel_adaptive
//                                    (per-instance early exit, snapshot
//                                    semantics)
// (the last parameter: with cone code, or none at all)
//
// What bounds it: operations, and more than the FLOP the instructions that
// carry them. One iteration is a pair of dependent recurrences of small
// matrix-vector products per instance (forward: the rollout, backward: the
// costate), 2 m (2 nx nu + nx^2 + nu nx + nu^2 + nx^2 + nx nu) FLOP (m = N-1
// knots), against ~7 KB per instance read and written once per solve. Every
// instance has its own matrices, so nothing is shared across a block and
// there is no tile for the tensor cores; within an instance the knots form a
// chain, so the parallelism is across instances and across the rows of one
// knot. What the card spends is the instructions a warp issues per knot.
//
// Design.
//  * Stacked rows. A group of G lanes owns one instance (G = 16 at 12/4 and
//    8/3; else the power of two >= nx + nu, at most 32): its nx state rows,
//    then its nu input rows; lane j owns rows j, j + G, ... Every lane does
//    the same product at each knot: forward, row j of [A; Kinf] times x_i
//    (a state row's part of A x_i, an input row's u_i = -Kinf x_i - d_i);
//    backward, row j of [AmBKt; B'] times p_{i+1} (a state row advances the
//    costate, an input row gives w_i = B' p_{i+1} + r_i).
//  * The reference's association on the chain: after a second barrier a
//    knot, x_{i+1} = A x_i + B u_i. (One barrier a knot with Acl = A - B
//    Kinf formed in the kernel, x_{i+1} = Acl x_i - B d_i, strayed further
//    from float64 than the plain versions do: PERF.md.) Backward, Kinf' r_i
//    and d_{i+1} = Quu_inv w_{i+1} (one knot later, after the next barrier)
//    sit beside the chain.
//  * No shuffles in the products. The vectors (x_i and u_i: the X and U
//    iterates themselves; p, w: double-buffered) sit in the group's slice
//    of shared memory; after a __syncwarp every lane reads them back with
//    broadcast float4 loads (the compiled body) or scalar ones. The residuals' maxima are one
//    integer reduction each (check iterations), the cone sums shuffles.
//  * The instance's knots live in shared memory for the whole solve, each a
//    record of stacked rows (state entries, then input ones) of x and u, the
//    slacks v and z (two rows in the adaptive kernel), the duals g and y,
//    the bounds, qc and d: a lane finds its own entries at fixed offsets
//    from the record. An instance comes in by cp.async (16-byte pieces in
//    the compiled body, 4-byte ones in the run-time one), all in flight at
//    once while its rows load. Instances' slices are padded so that the
//    groups of a warp touch different banks.
//  * Compiled bodies for 12/4 (the robust sweep's quadrotor family, the
//    timed one) and 8/3 (the design sweep's; records padded to 12 floats a
//    row): a lane's two product rows and its two thin rows (B or Quu_inv,
//    Kinf') in registers, launch bounds for 6 blocks of 128 threads an SM.
//    Every other size runs the same body with NX = NU = 0: sizes, loops and
//    the instance's rows in shared memory at run time, a lane owning
//    ceil((nx + nu) / G) rows, as far as shared memory takes one instance
//    (ops/hetero_admm.py hetero_plan, which mirrors make_layout).
//  * Per-instance slots. Persistent blocks (the grid the card holds at
//    once); each group takes an instance from a work counter (zeroed by the
//    wrapper before each launch), solves it, writes it back at its own
//    iteration boundary and takes the next at once, while its warp-mates
//    wait at the reconvergence point (measured against refilling once
//    every group of a warp is done: PERF.md). K7 runs the same body, which
//    evens out its last wave.
//  * Adaptive mode: the new slacks go to the other buffer; an instance that
//    converges at a check keeps the old slacks (pre-save Z, V), skips the
//    backward pass (pre-backward D) and keeps Y, G, U, X of that iteration.
//    Fixed mode: slacks in place, the last iteration's residuals against the
//    penultimate slacks; max_iter = 0 gives U = X = 0 and the carried slacks'
//    maxima. An instance's arithmetic depends on the instance alone: a
//    permuted batch, any refill order and a compacted re-launch
//    (hetero_cascade_solve) give the same bits.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream, does not synchronise, allocates nothing (the work counter is the
// caller's) and returns cudaGetLastError(), or -1 for sizes out of range or
// a shared-memory size that disagrees with the wrapper's.

#include <cuda_runtime.h>

#include <type_traits>

#include "group_ops.cuh"

// Stage hooks for tools/torch_hetero_stage_clocks.py (empty here).
#ifndef ATM_CLK
#define ATM_CLK_BEGIN() do { } while (0)
#define ATM_CLK(k) do { } while (0)
#define ATM_CLK_COUNT(k) do { } while (0)
#define ATM_CLK_END() do { } while (0)
#endif

namespace atm_hetero {

using atm_group::FULL;
using atm_group::clip;

constexpr int THREADS = 128;  // threads per block at most
constexpr int RMAX = 8;       // rows per lane at most (run-time body)

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// The shapes with a compiled body (nx a multiple of 4). Keep in step with
// ops/hetero_admm.py HETERO_SHAPES.
__host__ __device__ inline bool compiled_shape(int nx, int nu) {
  return (nx == 12 && nu == 4) || (nx == 8 && nu == 3);
}

// Lanes per instance: the power of two >= nx + nu, from 4 to 32.
__host__ __device__ inline int group_lanes(int nx, int nu) {
  int g = 4;
  while (g < nx + nu && g < 32) g *= 2;
  return g;
}

struct Args {
  const float *x0, *A, *Bm, *K, *Quu, *M;
  const float *umin, *umax, *xmin, *xmax, *qc, *pterm, *rho;
  const float *d0, *y0, *g0, *z0, *v0;
  float *U, *X, *d, *y, *g, *z, *v, *stats;
  const float *cparams, *cmasks;  // (Bn, nc, 2), (Bn, MR) or null
  const float* ctab;              // static cone table or null
  int* counter;                   // work counter, 0 at launch
  int Bn, nx, nu, N, max_iter, check_every, en_ib, en_sb;
  float pri_tol, dua_tol;
  int G, nc_u, nc_x;
};

// One instance's slice of dynamic shared memory, in floats (the slice a
// multiple of 4). Its knots are records of NA stacked rows of R = nx + nu
// floats (padded to a multiple of 4 in a compiled body, the padding zero),
// the nx state entries then the nu input ones: x_i and u_i (PRE),
// the slacks v, z (S0, and S1 in the adaptive kernel), the duals g, y
// (DU), the bounds (LO, HI), qc and d (QD). Row j of the instance is entry
// j of each, so a lane reaches its own at fixed offsets from the record.
// ops/hetero_admm.py inst_floats mirrors `inst`; the entry refuses a launch
// when the two disagree.
struct Layout {
  int R, W;                       // stacked row width, record width
  int PW, PT, REC;                // p|w (double-buffered), pterm, records
  int S0, S1, DU, LO, HI, QD;     // rows inside a record (PRE at 0)
  int CP, CR;                     // per cone mu, shift; a role per row
  int R1, R2, TB, TK, TQ;         // run-time body: [A; Kinf], [AmBKt; B']
                                  // rows (nx wide), B, Kinf', Quu_inv rows
  int inst;
};

__host__ __device__ inline Layout make_layout(int nx, int nu, int N, int nc,
                                              bool adaptive, bool compiled) {
  Layout L;
  const int R = compiled ? r4(nx + nu) : nx + nu, NA = adaptive ? 7 : 6;
  L.R = R;
  L.W = NA * R;
  L.S0 = R;
  L.S1 = adaptive ? 2 * R : R;
  L.DU = (NA - 4) * R;
  L.LO = (NA - 3) * R;
  L.HI = (NA - 2) * R;
  L.QD = (NA - 1) * R;
  int o = 0;
  L.PW = o; o += 2 * R;
  L.PT = o; o += r4(nx);
  L.REC = o; o += N * L.W;
  L.CP = o; o += 2 * nc;
  L.CR = o; o += nc * R;
  L.R1 = o; o += compiled ? 0 : (nx + nu) * nx;
  L.R2 = o; o += compiled ? 0 : (nx + nu) * nx;
  L.TB = o; o += compiled ? 0 : nx * nu;
  L.TK = o; o += compiled ? 0 : nx * nu;
  L.TQ = o; o += compiled ? 0 : nu * nu;
  L.inst = r4(o);
  return L;
}

// The floats between two instances' slices: `inst` padded so that the
// groups of a warp (G < 32 lanes each) start on different banks, and a
// lane's word and the same word of its warp-mates' instances never share
// a bank. ops/hetero_admm.py inst_stride mirrors it.
__host__ __device__ inline int inst_stride(int inst, int G) {
  return G < 32 ? inst + (G - inst % 32 + 32) % 32 : inst;
}

// ---------------------------------------------------------------- helpers --

// sum_c w[c] v[c] over n entries in shared memory: two accumulators, the
// even entries and the odd ones, each a chain of fmaf in order, then their
// sum. (This is the order of the lane-group kernel's shuffle products, so
// the products round as they did; sums of four accumulators, also tried,
// strayed further from float64 than the plain versions do: PERF.md.)
__device__ __forceinline__ float dotn(const float* w, const float* v, int n) {
  float a0 = 0.0f, a1 = 0.0f;
  int c = 0;
  for (; c + 2 <= n; c += 2) {
    a0 = fmaf(w[c], v[c], a0);
    a1 = fmaf(w[c + 1], v[c + 1], a1);
  }
  if (c < n) a0 = fmaf(w[c], v[c], a0);
  return a0 + a1;
}

// The same sum with a row in registers (PX a multiple of 4, zero past the
// row) and the vector read by float4 from shared memory (16-byte aligned).
template <int PX>
__device__ __forceinline__ float dotr(const float (&w)[PX], const float* v) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < PX; c += 4) {
    const float4 vv = reinterpret_cast<const float4*>(v)[c / 4];
    a0 = fmaf(w[c], vv.x, a0);
    a1 = fmaf(w[c + 1], vv.y, a1);
    a0 = fmaf(w[c + 2], vv.z, a0);
    a1 = fmaf(w[c + 3], vv.w, a1);
  }
  return a0 + a1;
}

// Kinf' r with r_q = -rho (z_q - y_q), over n entries, in dotn's order.
__device__ __forceinline__ float dot_r(const float* w, const float* z,
                                       const float* y, float rho, int n) {
  float a0 = 0.0f, a1 = 0.0f;
  int c = 0;
  for (; c + 2 <= n; c += 2) {
    a0 = fmaf(w[c], -rho * (z[c] - y[c]), a0);
    a1 = fmaf(w[c + 1], -rho * (z[c + 1] - y[c + 1]), a1);
  }
  if (c < n) a0 = fmaf(w[c], -rho * (z[c] - y[c]), a0);
  return a0 + a1;
}

template <int PU>
__device__ __forceinline__ float dotr_r(const float (&w)[PU], const float* z,
                                        const float* y, float rho) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < PU; c += 4) {
    const float4 z4 = reinterpret_cast<const float4*>(z)[c / 4];
    const float4 y4 = reinterpret_cast<const float4*>(y)[c / 4];
    a0 = fmaf(w[c], -rho * (z4.x - y4.x), a0);
    a1 = fmaf(w[c + 1], -rho * (z4.y - y4.y), a1);
    a0 = fmaf(w[c + 2], -rho * (z4.z - y4.z), a0);
    a1 = fmaf(w[c + 3], -rho * (z4.w - y4.w), a1);
  }
  return a0 + a1;
}

__device__ __forceinline__ float gsum(float v, unsigned mask, int G) {
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
  return v;
}

// max(a, b) of values >= 0 or NaN (absolute values), NaN if either is:
// such floats order as their bit patterns do.
__device__ __forceinline__ float amax(float a, float b) {
  return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
}

// The group's maximum of values >= 0 or NaN (residuals: absolute values),
// NaN if any is: such floats order as their bit patterns do, so one
// integer reduction over the group's lanes gives it.
__device__ __forceinline__ float gmax_abs(float v, unsigned mask) {
  return __uint_as_float(__reduce_max_sync(mask, __float_as_uint(v)));
}

// Asynchronous copies from device to shared memory (cp.async): 16 bytes
// (both addresses aligned) or 4; waited for by cp_wait_all.
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's rows in registers (the compiled body): r1 of [A; Kinf], r2 of
// [AmBKt; B'], t1 of B (a state row) or Quu_inv (an input row), t2 of Kinf'
// (a state row); zero past the plant's sizes.
template <int NX, int NU>
struct Rows {
  static constexpr int PX = (NX + 3) & ~3, PU = (NU + 3) & ~3;
  float r1[PX], r2[PX], t1[PU], t2[PU];
};
template <>
struct Rows<0, 0> {};

// ----------------------------------------------------------------- kernel --

extern __shared__ float4 hetero_smem4[];

template <int NX, int NU, bool ADAPTIVE, bool CONES>
__global__ void __launch_bounds__(THREADS, NX > 0 ? 6 : 3)
    hetero_kernel(Args a) {
  constexpr bool COMPILED = NX > 0;
  const int G = COMPILED ? 16 : a.G;
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const unsigned gmask =
      G == 32 ? FULL : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int Bn = a.Bn;
  const int nx = COMPILED ? NX : a.nx, nu = COMPILED ? NU : a.nu;
  const int N = a.N, m = N - 1;
  const int XN = N * nx, UM = m * nu;
  const int nc = a.nc_u + a.nc_x;
  const int rpl = COMPILED ? 1 : (nx + nu + G - 1) / G;
  const bool en_x = a.en_sb != 0, en_u = a.en_ib != 0;
  constexpr int RL = COMPILED ? 1 : RMAX;
  const Layout L = make_layout(nx, nu, N, nc, ADAPTIVE, COMPILED);
  const int R = L.R, W = L.W, RR = nx + nu;   // row width, rows
  const int stride = inst_stride(L.inst, G);
  float* const S = reinterpret_cast<float*>(hetero_smem4) + grp * stride;
  float* const rec0 = S + L.REC;          // knot i's record: rec0 + i W
  Rows<NX, NU> rw;
  float rho = 0.0f;
  ATM_CLK_BEGIN();
  // the padding of the records and of p|w stays zero (a compiled body's
  // float4 products read it)
  for (int e = lane; e < stride; e += G) S[e] = 0.0f;
  __syncwarp(gmask);

  auto claim = [&]() {
    int v = 0;
    if (lane == 0) v = atomicAdd(a.counter, 1);
    v = __shfl_sync(gmask, v, 0, G);
    return v < Bn ? v : -1;
  };

  // Instance bi into the slice: its knots (cp.async, in flight while the
  // rows load; 16-byte pieces in the compiled body, whose operands the
  // entry holds to 16-byte alignment), pterm, cones and rows.
  auto load = [&](int bi) {
    const size_t bl = bi;
    // record rows from the device arrays: pair p (state array, input
    // array) into record row row_of(p); p unrolled, so that each pair's
    // pointers and row are fixed
    auto src_of = [&](int p, bool st) -> const float* {
      switch (p) {
        case 0: return st ? a.v0 + bl * XN : a.z0 + bl * UM;
        case 1: return st ? a.g0 + bl * XN : a.y0 + bl * UM;
        case 2: return st ? a.xmin + bl * XN : a.umin + bl * UM;
        case 3: return st ? a.xmax + bl * XN : a.umax + bl * UM;
        default: return st ? a.qc + bl * XN : a.d0 + bl * UM;
      }
    };
    auto row_of = [&](int p) {
      return p == 0 ? L.S0 : p == 1 ? L.DU : p == 2 ? L.LO : p == 3 ? L.HI
                                                                    : L.QD;
    };
    if constexpr (COMPILED) {
      // per knot NX / 4 16-byte pieces of state, NU / 4 of input (NU
      // 4-byte ones where NU is not a multiple of 4)
      constexpr bool U4 = NU % 4 == 0;
      constexpr int PS = NX / 4, PK = PS + (U4 ? NU / 4 : NU);
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const float* xs = src_of(p, true);
        const float* us = src_of(p, false);
        float* const dst = rec0 + row_of(p);
        for (int e = lane; e < N * PK; e += G) {
          const int i = e / PK, c = e - i * PK, cu = c - PS;
          if (c < PS) cp16(dst + i * W + 4 * c, xs + i * NX + 4 * c);
          else if (i < m && U4)
            cp16(dst + i * W + NX + 4 * cu, us + i * NU + 4 * cu);
          else if (i < m) cp4(dst + i * W + NX + cu, us + i * NU + cu);
        }
      }
      for (int c = lane; c < PS; c += G) {
        cp16(rec0 + 4 * c, a.x0 + bl * NX + 4 * c);
        cp16(S + L.PT + 4 * c, a.pterm + bl * NX + 4 * c);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const float* xs = src_of(p, true);
        const float* us = src_of(p, false);
        float* const dst = rec0 + row_of(p);
        for (int e = lane; e < XN; e += G) {
          const int i = e / nx;
          cp4(dst + i * W + e - i * nx, xs + e);
        }
        for (int e = lane; e < UM; e += G) {
          const int i = e / nu;
          cp4(dst + i * W + nx + e - i * nu, us + e);
        }
      }
      for (int k = lane; k < nx; k += G) {
        cp4(rec0 + k, a.x0 + bl * nx + k);
        cp4(S + L.PT + k, a.pterm + bl * nx + k);
      }
    }
    if (CONES) {
      // per cone mu, shift; the role of each stacked row (1 ball, 2 axis, 0
      // neither) from the static table or the instance's cparams / cmasks
      const int tw = nx > nu ? nx : nu;
      const int MR = 2 * nu * a.nc_u + 2 * nx * a.nc_x;
      for (int c = lane; c < nc; c += G) {
        S[L.CP + 2 * c] = a.cparams ? a.cparams[(bl * nc + c) * 2]
                                    : a.ctab[c * (2 + tw)];
        S[L.CP + 2 * c + 1] = a.cparams ? a.cparams[(bl * nc + c) * 2 + 1]
                                        : a.ctab[c * (2 + tw) + 1];
      }
      for (int e = lane; e < nc * R; e += G) {
        const int c = e / R, j = e - c * R;
        const bool in_u = c < a.nc_u;
        const int dim = in_u ? nu : nx, k = in_u ? j - nx : j;
        float role = 0.0f;
        if (k >= 0 && k < dim) {
          if (a.cmasks) {
            const int off = in_u ? 2 * nu * c
                                 : 2 * nu * a.nc_u + 2 * nx * (c - a.nc_u);
            const float* cm = a.cmasks + bl * MR + off;
            role = cm[k] != 0.0f ? 1.0f : (cm[dim + k] != 0.0f ? 2.0f : 0.0f);
          } else {
            role = a.ctab[c * (2 + tw) + 2 + k];
          }
        }
        S[L.CR + e] = role;
      }
    }
    const float* A = a.A + bl * nx * nx;
    const float* Bm = a.Bm + bl * nx * nu;
    const float* K = a.K + bl * nu * nx;
    const float* Q = a.Quu + bl * nu * nu;
    const float* M = a.M + bl * nx * nx;
    if constexpr (COMPILED) {
      // rows in 16-byte pieces where their length is a multiple of 4
      auto ld = [](float* dst, const float* src, auto n_) {
        constexpr int n = decltype(n_)::value;
        if constexpr (n % 4 == 0) {
#pragma unroll
          for (int c = 0; c < n; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + c);
            dst[c] = v.x; dst[c + 1] = v.y; dst[c + 2] = v.z;
            dst[c + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < n; ++c) dst[c] = src[c];
        }
      };
      constexpr std::integral_constant<int, NX> nx_c{};
      constexpr std::integral_constant<int, NU> nu_c{};
#pragma unroll
      for (int q = 0; q < Rows<NX, NU>::PU; ++q) rw.t1[q] = rw.t2[q] = 0.0f;
      if (lane < NX) {           // state row k: A, AmBKt, B, Kinf'
        const int k = lane;
        ld(rw.t1, Bm + k * NU, nu_c);
        ld(rw.r1, A + k * NX, nx_c);
        ld(rw.r2, M + k * NX, nx_c);
#pragma unroll
        for (int q = 0; q < NU; ++q) rw.t2[q] = K[q * NX + k];
      } else if (lane < NX + NU) {  // input row k: Kinf, B', Quu_inv
        const int k = lane - NX;
        ld(rw.r1, K + k * NX, nx_c);
        ld(rw.t1, Q + k * NU, nu_c);
#pragma unroll
        for (int c = 0; c < NX; ++c) rw.r2[c] = Bm[c * NU + k];
      } else {                   // no row
#pragma unroll
        for (int c = 0; c < NX; ++c) rw.r1[c] = rw.r2[c] = 0.0f;
      }
    } else {
      for (int e = lane; e < nx * nu; e += G) {
        S[L.TB + e] = Bm[e];
        const int q = e / nx, k = e - q * nx;     // K (nu, nx)
        S[L.TK + k * nu + q] = K[e];
        S[L.R1 + nx * nx + e] = K[e];             // Kinf rows
      }
      for (int e = lane; e < nu * nu; e += G) S[L.TQ + e] = Q[e];
      for (int e = lane; e < nx * nx; e += G) {
        S[L.R1 + e] = A[e];
        S[L.R2 + e] = M[e];
      }
      __syncwarp(gmask);
      for (int e = lane; e < nu * nx; e += G) {
        const int k = e / nx, c = e - k * nx;     // B' row k
        S[L.R2 + nx * nx + e] = S[L.TB + c * nu + k];
      }
    }
    rho = a.rho[bl];
    cp_wait_all();
    __syncwarp(gmask);
  };

  // Forward: rollout fused with the slack projection, cones and dual update,
  // knot by knot; old slacks in row ro of the records, new ones to row wn
  // (the same row in the fixed kernel). With res the residual maxima come
  // back group-reduced (reference admm.cpp:95-98; dual ones without rho).
  // Every lane runs the same instructions at every knot: the input rows'
  // work at the last knot (which has no input) and the compiled body's
  // B u_i of an input row are done and never stored, so that the knot
  // step has no branch that splits a group.
  float rpx = 0.0f, rdx = 0.0f, rpu = 0.0f, rdu = 0.0f;
  auto forward = [&](int ro, int wn, bool res) {
    rpx = rdx = rpu = rdu = 0.0f;
#pragma unroll 1
    for (int i = 0; i <= m; ++i) {
      __syncwarp(gmask);                  // x_i (and d_i) from every lane
      float* const rc = rec0 + i * W;
      float acc_[RL] = {}, pre_[RL] = {}, tsum_[RL] = {}, s_[RL] = {};
#pragma unroll
      for (int t = 0; t < RL; ++t) {
        const int j = lane + t * G;
        if (t >= rpl || j >= RR) break;
        const bool isx = j < nx;
        // A x_i (a state row) or Kinf x_i (an input row)
        float acc;
        if constexpr (COMPILED) acc = dotr(rw.r1, rc);
        else acc = dotn(S + L.R1 + j * nx, rc, nx);
        const float v1 = rc[(isx ? 0 : L.QD) + j];
        const float pre = isx ? v1 : -acc - v1;     // x_i, or u_i
        if (!isx && i < m) rc[j] = pre;
        const float tsum = pre + rc[L.DU + j];
        float s = tsum;
        if (isx ? en_x : en_u) s = clip(tsum, rc[L.LO + j], rc[L.HI + j]);
        acc_[t] = acc;
        pre_[t] = pre;
        tsum_[t] = tsum;
        s_[t] = s;
      }
      if (i < m) {
        __syncwarp(gmask);                // u_i from every input row
        // the chain: x_{i+1} = A x_i + B u_i
#pragma unroll
        for (int t = 0; t < RL; ++t) {
          const int j = lane + t * G;
          if (t >= rpl || j >= RR) break;
          const bool isx = j < nx;
          float bu;
          if constexpr (COMPILED) bu = dotr(rw.t1, rc + NX);
          else bu = isx ? dotn(S + L.TB + j * nu, rc + nx, nu) : 0.0f;
          if (isx) rc[W + j] = acc_[t] + bu;
        }
      }
      if (CONES && nc > 0) {
        // cones in order on the knot's slacks (solver/cones.py): the ball's
        // norm and the axis value as group sums over the rows' roles
        for (int c = 0; c < nc; ++c) {
          const bool in_u = c < a.nc_u;
          if (in_u && i == m) continue;
          const float mu = S[L.CP + 2 * c], sh = S[L.CP + 2 * c + 1];
          float bb = 0.0f, ax = 0.0f;
#pragma unroll
          for (int t = 0; t < RL; ++t) {
            const int j = lane + t * G;
            if (t >= rpl || j >= RR) break;
            const float role = S[L.CR + c * R + j];
            bb = role == 1.0f ? fmaf(s_[t], s_[t], bb) : bb;
            ax = role == 2.0f ? ax + s_[t] : ax;
          }
          const float a2 = gsum(bb, gmask, G);
          const float sv = gsum(ax, gmask, G) + sh;
          const float an = sqrtf(a2);
          const bool inside = an <= mu * sv;
          const bool polar = mu * an <= -sv;
          const float cc = (mu * an + sv) / (mu * mu + 1.0f);
          const float safe_a = a2 == 0.0f ? an + 1.0f : an;
          const float scale = inside ? 1.0f : (polar ? 0.0f : mu * cc / safe_a);
          const float s_new = (inside ? sv : (polar ? 0.0f : cc)) - sh;
#pragma unroll
          for (int t = 0; t < RL; ++t) {
            const int j = lane + t * G;
            if (t >= rpl || j >= RR) break;
            const float role = S[L.CR + c * R + j];
            s_[t] = role == 1.0f ? s_[t] * scale
                    : (role == 2.0f ? s_new : s_[t]);
          }
        }
      }
      // residuals, the new slack and the dual update
#pragma unroll
      for (int t = 0; t < RL; ++t) {
        const int j = lane + t * G;
        if (t >= rpl || j >= RR) break;
        const bool isx = j < nx, in = isx || i < m;
        const float s = s_[t];
        if (res) {
          const float dp = fabsf(pre_[t] - s);
          const float dd = fabsf(rc[ro + j] - s);
          rpx = isx ? amax(rpx, dp) : rpx;
          rdx = isx ? amax(rdx, dd) : rdx;
          rpu = isx || !in ? rpu : amax(rpu, dp);
          rdu = isx || !in ? rdu : amax(rdu, dd);
        }
        if (in) {
          rc[wn + j] = s;
          rc[L.DU + j] = tsum_[t] - s;
        }
      }
      ATM_CLK(1);
      ATM_CLK_COUNT(6);
    }
    if (res) {
      rpx = gmax_abs(rpx, gmask);
      rdx = gmax_abs(rdx, gmask);
      rpu = gmax_abs(rpu, gmask);
      rdu = gmax_abs(rdu, gmask);
    }
  };

  // Backward gradient recursion (reference admm.cpp:15-22 with the
  // linear-cost refresh :77-85) from the slacks in record row sb; writes D.
  // Buffer t & 1 of PW takes p_i in its state entries and w_i in its input
  // ones. As forward, every lane runs the same instructions (p_0 is
  // computed and never read; d of a state row is never stored).
  auto backward = [&](int sb) {
    __syncwarp(gmask);                    // the forward's slacks and duals
    {
      const float* rc = rec0 + m * W;
      for (int k = lane; k < nx; k += G)  // terminal costate p_m
        S[L.PW + k] = S[L.PT + k] - rho * (rc[sb + k] - rc[L.DU + k]);
    }
    ATM_CLK(2);
#pragma unroll 1
    for (int t = 1; t <= m; ++t) {
      const int i = m - t;
      __syncwarp(gmask);                  // p_{i+1} and w_{i+1}
      float* const rc = rec0 + i * W;
      const float* pc = S + L.PW + ((t - 1) & 1) * R;
      float* pn = S + L.PW + (t & 1) * R;
#pragma unroll
      for (int tt = 0; tt < RL; ++tt) {
        const int j = lane + tt * G;
        if (tt >= rpl || j >= RR) break;
        const bool isx = j < nx;
        // AmBKt p_{i+1} (a state row) or B' p_{i+1} (an input row)
        float acc;
        if constexpr (COMPILED) acc = dotr(rw.r2, pc);
        else acc = dotn(S + L.R2 + j * nx, pc, nx);
        // q = qc - rho (v - g) (a state row), r = -rho (z - y) (an input
        // row, rounded before the sum w = B' p + r, never fused into it)
        const float sd = rc[sb + j] - rc[L.DU + j];
        const float q = rc[L.QD + j] - rho * sd;
        const float rr = __fmul_rn(-rho, sd);
        float kr, dv;                     // Kinf' r; Quu_inv w_{i+1}
        if constexpr (COMPILED) {
          kr = dotr_r(rw.t2, rc + sb + NX, rc + L.DU + NX, rho);
          dv = dotr(rw.t1, pc + NX);
        } else {
          kr = isx ? dot_r(S + L.TK + j * nu, rc + sb + nx, rc + L.DU + nx,
                           rho, nu)
                   : 0.0f;
          dv = isx || t < 2 ? 0.0f
                            : dotn(S + L.TQ + (j - nx) * nu, pc + nx, nu);
        }
        pn[j] = isx ? (q + acc) - kr : acc + rr;
        if (!isx && t >= 2) rc[W + L.QD + j] = dv;   // d_{i+1}
      }
      ATM_CLK(2);
      ATM_CLK_COUNT(7);
    }
    __syncwarp(gmask);                    // w_0
    const float* w0 = S + L.PW + (m & 1) * R + nx;
#pragma unroll
    for (int tt = 0; tt < RL; ++tt) {     // d_0 = Quu_inv w_0
      const int j = lane + tt * G;
      if (tt >= rpl || j >= RR) break;
      if (j < nx) continue;
      float dv;
      if constexpr (COMPILED) dv = dotr(rw.t1, w0);
      else dv = dotn(S + L.TQ + (j - nx) * nu, w0, nu);
      rec0[L.QD + j] = dv;
    }
  };

  // The instance's results out, from record row sb (U = X = 0 with zero).
  int b = -1, kc = 0, par = 0;
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto retire = [&](int sb, float iters, float solved, bool zero) {
    const size_t bl = b;
    __syncwarp(gmask);                    // every lane's last stores
    // pair p (record row, state array, input array), p unrolled: x|u to
    // X, U; the slacks to v, z; the duals to g, y; d to d
    auto dst_of = [&](int p, bool st) -> float* {
      switch (p) {
        case 0: return st ? a.X + bl * XN : a.U + bl * UM;
        case 1: return st ? a.v + bl * XN : a.z + bl * UM;
        case 2: return st ? a.g + bl * XN : a.y + bl * UM;
        default: return st ? nullptr : a.d + bl * UM;
      }
    };
    auto row_of = [&](int p) {
      return p == 0 ? 0 : p == 1 ? sb : p == 2 ? L.DU : L.QD;
    };
    if constexpr (COMPILED) {
      constexpr bool U4 = NU % 4 == 0;
      constexpr int PS = NX / 4, PK = PS + (U4 ? NU / 4 : NU);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float* const xd = dst_of(p, true);
        float* const ud = dst_of(p, false);
        const float* src = rec0 + row_of(p);
        for (int e = lane; e < N * PK; e += G) {
          const int i = e / PK, c = e - i * PK, cu = c - PS;
          if (c < PS) {
            if (p == 3) continue;
            float4 val = reinterpret_cast<const float4*>(src + i * W)[c];
            if (zero && p == 0) val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            *reinterpret_cast<float4*>(xd + i * NX + 4 * c) = val;
          } else if (i < m && U4) {
            float4 val = *reinterpret_cast<const float4*>(
                src + i * W + NX + 4 * cu);
            if (zero && p == 0) val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            *reinterpret_cast<float4*>(ud + i * NU + 4 * cu) = val;
          } else if (i < m) {
            const float val = src[i * W + NX + cu];
            ud[i * NU + cu] = zero && p == 0 ? 0.0f : val;
          }
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float* const xd = dst_of(p, true);
        float* const ud = dst_of(p, false);
        const float* src = rec0 + row_of(p);
        if (p < 3)
          for (int e = lane; e < XN; e += G) {
            const int i = e / nx;
            xd[e] = zero && p == 0 ? 0.0f : src[i * W + e - i * nx];
          }
        for (int e = lane; e < UM; e += G) {
          const int i = e / nu;
          ud[e] = zero && p == 0 ? 0.0f : src[i * W + nx + e - i * nu];
        }
      }
    }
    if (lane == 0) {
      float* st = a.stats + bl * 8;
      st[0] = iters; st[1] = solved;
      st[2] = r[0]; st[3] = r[1]; st[4] = r[2]; st[5] = r[3];
      st[6] = 0.0f; st[7] = 0.0f;
    }
    __syncwarp(gmask);                    // before the slice is refilled
    ATM_CLK(3);
  };

  // One call site each for the claim, the load and the write-back (they
  // are inlined): a group takes an instance, iterates it to its end,
  // writes it back, and takes the next one.
  for (;;) {
    if (b < 0) {
      b = claim();
      if (b < 0) break;
      load(b);
      kc = 0;
      par = 0;
      r[0] = r[1] = r[2] = r[3] = 0.0f;
      ATM_CLK(0);
      ATM_CLK_COUNT(9);
    }
    ATM_CLK(5);
    int sb = L.S0;                        // the final slacks' record row
    float iters = 0.0f, solved = 0.0f;
    bool done = false, zero = false;
    if (!ADAPTIVE) {
      if (a.max_iter <= 0) {              // U = X = 0 against the carry
        float ps = 0.0f, pu_ = 0.0f;
        for (int e = lane; e < N * R; e += G) {
          const int i = e / R, j = e - i * R;
          const float sv = fabsf(rec0[i * W + L.S0 + j]);
          if (j < nx) ps = amax(ps, sv);
          else if (i < m && j < RR) pu_ = amax(pu_, sv);
        }
        r[0] = gmax_abs(ps, gmask);
        r[2] = gmax_abs(pu_, gmask);
        done = zero = true;
      } else {
        // Fixed: slacks in place; the last iteration's residuals compare
        // the final slacks with the penultimate ones.
        ++kc;
        const bool last = kc == a.max_iter;
        forward(L.S0, L.S0, last);
        if (last) {
          r[0] = rpx; r[1] = rho * rdx; r[2] = rpu; r[3] = rho * rdu;
        }
        backward(L.S0);
        done = last;
        iters = (float)a.max_iter;
      }
    } else {
      // Adaptive: a check at every in-call iteration kc that is a multiple
      // of check_every; residual stats are the last check's.
      ++kc;
      const bool chk = kc % a.check_every == 0;
      const int so = par ? L.S1 : L.S0, sn = par ? L.S0 : L.S1;
      forward(so, sn, chk);
      bool newly = false;
      if (chk) {
        r[0] = rpx; r[1] = rho * rdx; r[2] = rpu; r[3] = rho * rdu;
        newly = r[0] < a.pri_tol && r[2] < a.pri_tol && r[1] < a.dua_tol &&
                r[3] < a.dua_tol;
      }
      if (!newly) {
        backward(sn);
        par ^= 1;
      }
      done = newly || kc == a.max_iter;
      sb = newly ? so : sn;
      iters = newly ? (float)kc : (float)a.max_iter;
      solved = newly ? 1.0f : 0.0f;
    }
    ATM_CLK(4);
    ATM_CLK_COUNT(8);
    if (done) {
      retire(sb, iters, solved, zero);
      b = -1;
    }
  }
  ATM_CLK_END();
}

// ------------------------------------------------------------------ launch --

using Kernel = void (*)(Args);

template <int NX, int NU>
static Kernel pick_mode(bool adaptive, bool coned) {
  return adaptive ? (coned ? hetero_kernel<NX, NU, true, true>
                           : hetero_kernel<NX, NU, true, false>)
                  : (coned ? hetero_kernel<NX, NU, false, true>
                           : hetero_kernel<NX, NU, false, false>);
}

static Kernel pick(int nx, int nu, bool adaptive, bool coned) {
  if (nx == 12 && nu == 4) return pick_mode<12, 4>(adaptive, coned);
  if (nx == 8 && nu == 3) return pick_mode<8, 3>(adaptive, coned);
  return pick_mode<0, 0>(adaptive, coned);
}

// Dynamic shared memory of one block of `threads` threads.
static int block_bytes(int nx, int nu, int N, int nc, bool adaptive,
                       int threads) {
  const int G = group_lanes(nx, nu);
  return threads / G * 4 *
         inst_stride(make_layout(nx, nu, N, nc, adaptive,
                                 compiled_shape(nx, nu)).inst, G);
}

// Blocks of `kernel` an SM holds at once, with its shared memory set; a
// negative CUDA error on failure.
static int resident(Kernel kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  return err == cudaSuccess ? n : -(int)err;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace atm_hetero

extern "C" {

// Blocks an SM holds at once for a launch of these sizes (threads per
// block), or a negative CUDA error.
int atm_hetero_resident(int nx, int nu, int N, int nc, int adaptive,
                        int threads) {
  using namespace atm_hetero;
  return resident(pick(nx, nu, adaptive != 0, nc > 0), threads,
                  block_bytes(nx, nu, N, nc, adaptive != 0, threads));
}

// One batched solve. check_every == 0: fixed max_iter iterations (K7); > 0:
// the adaptive kernel (K8). cone_tab == nullptr: no cones; otherwise the
// device table of nc_u input and nc_x state cones (per cone a row of 2 +
// max(nx, nu) floats: mu, shift, then each component's role, 1 in the ball,
// 2 the axis, 0 neither); cparams (Bn, nc, 2) and cmasks (Bn, MR) are device
// arrays of per-instance values or nullptr. counter: one int, 0 at launch.
// threads per block (a multiple of 32 and of the group, at most 128) with
// smem_bytes of dynamic shared memory, which must equal the layout's count
// (make_layout; ops/hetero_admm.py inst_floats).
int atm_hetero_solve(
    const float* x0, const float* A, const float* Bm, const float* K,
    const float* Quu, const float* M, const float* umin, const float* umax,
    const float* xmin, const float* xmax, const float* qc, const float* pterm,
    const float* rho, const float* d0, const float* y0, const float* g0,
    const float* z0, const float* v0,
    float* U, float* X, float* d, float* y, float* g, float* z, float* v,
    float* stats,
    const float* cone_tab, int nc_u, int nc_x, const float* cparams,
    const float* cmasks, int* counter,
    int Bn, int nx, int nu, int N, int max_iter, int check_every, int en_ib,
    int en_sb, float pri_tol, float dua_tol, int threads, int smem_bytes,
    void* stream) {
  using namespace atm_hetero;
  const int G = group_lanes(nx, nu);
  const int nc = nc_u + nc_x;
  if (Bn <= 0 || nx < 1 || nu < 1 || N < 2 || max_iter < 0 ||
      check_every < 0 || (check_every > 0 && max_iter < 1) ||
      threads < 32 || threads > THREADS || threads % 32 || threads % G ||
      (nx + nu + G - 1) / G > RMAX || nc_u < 0 || nc_x < 0 ||
      (nc > 0) != (cone_tab != nullptr) ||
      (nc == 0 && (cparams != nullptr || cmasks != nullptr)) ||
      counter == nullptr ||
      smem_bytes != block_bytes(nx, nu, N, nc, check_every > 0, threads))
    return -1;
  Args a = {};
  a.x0 = x0; a.A = A; a.Bm = Bm; a.K = K; a.Quu = Quu; a.M = M;
  a.umin = umin; a.umax = umax; a.xmin = xmin; a.xmax = xmax;
  a.qc = qc; a.pterm = pterm; a.rho = rho;
  a.d0 = d0; a.y0 = y0; a.g0 = g0; a.z0 = z0; a.v0 = v0;
  a.U = U; a.X = X; a.d = d; a.y = y; a.g = g; a.z = z; a.v = v;
  a.stats = stats;
  a.cparams = cparams; a.cmasks = cmasks; a.ctab = cone_tab;
  a.counter = counter;
  a.Bn = Bn; a.nx = nx; a.nu = nu; a.N = N; a.max_iter = max_iter;
  a.check_every = check_every; a.en_ib = en_ib; a.en_sb = en_sb;
  a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  a.G = G; a.nc_u = nc_u; a.nc_x = nc_x;
  // the compiled body moves every operand in 16-byte pieces
  const void* arrays[] = {x0, A, Bm, K, Quu, M, umin, umax, xmin, xmax, qc,
                          pterm, d0, y0, g0, z0, v0, U, X, d, y, g, z, v};
  if (compiled_shape(nx, nu))
    for (const void* p : arrays)
      if (!aligned16(p)) return -1;
  Kernel kernel = pick(nx, nu, check_every > 0, nc > 0);
  const int per_sm = resident(kernel, threads, smem_bytes);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return -1;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ipb = threads / G;
  int blocks = (Bn + ipb - 1) / ipb;
  if (blocks > per_sm * n_sm) blocks = per_sm * n_sm;
  kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
