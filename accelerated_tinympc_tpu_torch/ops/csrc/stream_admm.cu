// Long-horizon ADMM kernels for Hopper (sm_90a), FP32, one distinct plant
// per instance (K11, K12):
//
//   hstream_kernel<NX, NU, false, *>  replaces accelerated_tinympc_tpu/ops/
//                                     hstream_admm.py _kernel (fixed
//                                     iterations; its _make_streamer phases)
//   hstream_kernel<NX, NU, true, *>   replaces hstream_admm.py
//                                     _kernel_adaptive (per-instance early
//                                     exit)
// (the last parameter: with cone code, or none at all)
//
// (The shared-plant kernels K9/K10 are csrc/stream_shared.cu.)
//
// What bounds it: memory traffic, then the latency of the knot chain. At N
// in the hundreds one instance's iterates (d, y, z: (N-1) nu; g, v: N nx
// floats) and qc take ~49 KB at nx=12, nu=4, N=256, so a batch of thousands
// lives in device memory and every iteration streams it: the forward sweep
// reads d, y, g (and the old z, v where residuals are taken) and writes y,
// z, g, v; the backward sweep reads y, z, g, v and qc and writes d. Within
// an instance the knots form a chain (x_{i+1} from x_i; p_i from p_{i+1}),
// so the parallelism is across instances and across the rows of one knot.
//
// Design.
//  * A group of G lanes owns one instance (G = 16 at the compiled shapes;
//    else the power of two >= nx + nu, at most 32). Its rows are the nx
//    state rows and then the nu input rows: lane j owns rows j, j + G, ...
//    Every lane does the same product at each knot: forward, row j of
//    [Acl; Kinf] times x_i (a state row advances the chain, an input row
//    gives u_i); backward, row j of [AmBKt; B'] times p_{i+1} (a state row
//    advances the costate, an input row gives w = B' p + r).
//  * One product on each chain. u_i = -Kinf x_i - d_i is the unclipped
//    input, so x_{i+1} = A x_i + B u_i = Acl x_i - B d_i with Acl = A - B
//    Kinf: the chain is one nx x nx product, and B d_i (d_i from the knot's
//    copy) and Kinf x_i (u, its clip, cones and stores) sit beside it.
//    Acl is formed here in float32 from the instance's A, B and Kinf, once
//    per launch (fmaf in a fixed order), not taken from the cache's AmBKt:
//    the rollout then depends on the plant and gain alone, as in the plain
//    version, whose association (A x + B u) it differs from by rounding.
//    Backward: AmBKt p_{i+1} is the chain; B' p, Quu_inv w (one knot later,
//    after the next barrier) and Kinf' r sit beside it.
//  * No shuffles in the products. A group writes its vector (x or p) to its
//    slice of shared memory, double buffered, and after one __syncwarp per
//    knot every lane reads it back with broadcast float4 loads (3 at
//    nx=12). Shuffles remain only in the residuals' maxima (check
//    iterations).
//  * Registers: at 12/4 and 8/3 (compiled, compiled_shape) a lane keeps
//    its two rows (nx floats each) in registers; the thin matrices (B,
//    Kinf', Quu_inv) sit in the group's slice of shared memory, read by
//    float4. The launch bounds hold it to 64 registers, so an SM holds 8
//    blocks of 8 instances and 8,192 instances take one wave on 132 SMs.
//    Every other size runs the same body with NX = NU = 0: rows per lane,
//    loops and the plant's rows in shared memory at run time, as far as
//    shared memory takes them (ops/stream_admm.py hstream_plan), held to
//    168 registers (3 blocks an SM).
//  * Knot prefetch: each group keeps a ring of kb knots in its slice of
//    shared memory, filled by cp.async in 16-byte pieces spread over its
//    lanes, kb - 1 knots ahead of the one computed (forward: d, y, g, the
//    old z, v where residuals are taken, the bounds where they come per
//    knot; backward: y, z, g, v, qc). The iterates are batch-leading with
//    each knot's row padded to a multiple of 4 floats ((Bn, N-1, r4(nu)),
//    (Bn, N, r4(nx)); the wrapper pads where nx or nu is not a multiple of
//    4), so a knot's row is 16-byte aligned.
//  * Slacks in place except on checks: a check iteration writes the new
//    slacks to zs/vs and keeps z/v; an instance that converges there keeps
//    the old ones (pre-save Z, V) and skips the backward pass (pre-backward
//    D); one that goes on reads them back in its backward sweep and writes
//    them to z/v. U and X are written on every check iteration and at the
//    cap, while the instance is live. A warp runs until all its groups are
//    done.
//  * An instance's arithmetic depends on the instance alone: a permuted
//    batch, a compacted relaunch (hstream_cascade_solve) and any kb give the
//    same bits.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError(), or -1 for arguments out of range or a shared-memory
// size that disagrees with the wrapper's. The carry arrays d, y, g, z, v
// are updated in place (the caller passes copies of the warm start).

#include <cuda_runtime.h>

#include "group_ops.cuh"

// Stage hooks for tools/torch_stream_stage_clocks.py (empty here).
#ifndef ATM_CLK
#define ATM_CLK_BEGIN() do { } while (0)
#define ATM_CLK(k) do { } while (0)
#define ATM_CLK_COUNT(k) do { } while (0)
#define ATM_CLK_END() do { } while (0)
#endif

namespace atm_stream {

using atm_group::FULL;
using atm_group::clip;
using atm_group::nanmax;

constexpr int THREADS = 128;  // threads per block at most
constexpr int KB_MAX = 8;     // knots a group keeps in flight at most
constexpr int RMAX = 8;       // rows per lane at most (run-time body)

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// The shapes with a compiled body (rows in registers, one a lane, 16 lanes
// an instance): the robust sweep's quadrotor family (12/4, the timed one)
// and the long-horizon example's plant (8/3). Keep in step with
// ops/stream_admm.py HSTREAM_SHAPES.
__host__ __device__ inline bool compiled_shape(int nx, int nu) {
  return (nx == 12 && nu == 4) || (nx == 8 && nu == 3);
}

// Lanes per instance: 16 for a compiled body, else the power of two >= nx +
// nu (4 .. 32).
__host__ __device__ inline int group_lanes(int nx, int nu) {
  if (compiled_shape(nx, nu)) return 16;
  int g = 4;
  while (g < nx + nu && g < 32) g *= 2;
  return g;
}

struct Args {
  const float *x0, *A, *Bm, *K, *Quu, *M;
  const float *umin, *umax, *xmin, *xmax, *qc, *pterm, *rho;
  float *U, *X, *d, *y, *g, *z, *v, *zs, *vs, *stats;
  const float *cparams, *cmasks, *ctab;
  int bk;  // bounds a (padded) row per knot, else one row per instance
  int Bn, nx, nu, N, max_iter, check_every, en_ib, en_sb, kb, G, ipb;
  float pri_tol, dua_tol;
  int nc_u, nc_x;
};

// Offsets, in floats, inside one instance's slice of dynamic shared memory
// (every one a multiple of 4). ops/stream_admm.py hstream_smem_bytes mirrors
// `inst`; the entry refuses a launch when the two disagree.
struct Layout {
  int R1, R2;       // run-time body: rows of [Acl; Kinf], [AmBKt; B'] (px)
  int TB, TK, TQ;   // rows of B, Kinf' (pu each, nx rows), Quu_inv (nu rows)
  int xs, ps, ws;   // x, p (2 x px) and w (2 x pu), double buffered
  int sl;           // the knot's slacks under cone projection: x, then u
  int pt, xl, xh, ul, uh, cn;  // pterm, uniform bounds, cone rows
  int ring, rw;     // kb knot entries of rw floats
  int oD, oY, oZ, oG, oV, oQ, oXL, oXH, oUL, oUH;  // inside an entry
  int inst;
};

__host__ __device__ inline Layout make_layout(int nx, int nu, int kb, int nc,
                                              int bk, bool compiled) {
  Layout L;
  const int px = r4(nx), pu = r4(nu), tw = nx > nu ? nx : nu;
  const int rows = nx + nu;
  int o = 0;
  L.R1 = o; o += compiled ? 0 : rows * px;
  L.R2 = o; o += compiled ? 0 : rows * px;
  L.TB = o; o += nx * pu;
  L.TK = o; o += nx * pu;
  L.TQ = o; o += nu * pu;
  L.xs = o; o += 2 * px;
  L.ps = o; o += 2 * px;
  L.ws = o; o += 2 * pu;
  L.sl = o; o += px + pu;
  L.pt = o; o += px;
  L.xl = o; o += px;
  L.xh = o; o += px;
  L.ul = o; o += pu;
  L.uh = o; o += pu;
  L.cn = o; o += r4(nc * (2 + tw));
  L.oD = 0;
  L.oY = pu;
  L.oZ = 2 * pu;
  L.oG = 3 * pu;
  L.oV = 3 * pu + px;
  L.oQ = 3 * pu + 2 * px;
  L.oXL = 3 * pu + 3 * px;
  L.oXH = 3 * pu + 4 * px;
  L.oUL = 3 * pu + 5 * px;
  L.oUH = 4 * pu + 5 * px;
  L.rw = 3 * pu + 3 * px + (bk ? 2 * px + 2 * pu : 0);
  L.ring = o; o += kb * L.rw;
  L.inst = o;
  return L;
}

// ---------------------------------------------------------------- helpers --

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's most recent groups are pending.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// One 16-byte piece of a knot's copy into a ring entry: its source at knot
// 0, and in `meta` its place in the entry (bits 0-15), its stride per knot
// in floats (16-27) and 1 + the knots that have it (28-30: 1 every knot, 2
// the input knots i < m, 3 the knots 0 < i < m); meta 0: no piece.
struct Copy {
  const float* src;
  int meta;
};

__device__ __forceinline__ Copy make_copy(const float* src, int stride,
                                          int dst, int kind) {
  return Copy{src, dst | stride << 16 | (kind + 1) << 28};
}

__device__ __forceinline__ void issue(const Copy& c, int i, int m,
                                      float* slot) {
  const int kind = (c.meta >> 28) - 1;
  if (kind == 0 || (kind == 1 && i < m) || (kind == 2 && i > 0 && i < m))
    cp16(slot + (c.meta & 0xffff), c.src + i * ((c.meta >> 16) & 0xfff));
}

// sum_k w[k] v[k] over n4 float4 chunks of a shared-memory row and vector
// (16-byte aligned, zero padded), in four accumulators.
__device__ __forceinline__ float dot4(const float* w, const float* v,
                                      int n4) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int c = 0; c < n4; ++c) {
    const float4 wv = reinterpret_cast<const float4*>(w)[c];
    const float4 vv = reinterpret_cast<const float4*>(v)[c];
    a0 = fmaf(wv.x, vv.x, a0);
    a1 = fmaf(wv.y, vv.y, a1);
    a2 = fmaf(wv.z, vv.z, a2);
    a3 = fmaf(wv.w, vv.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// A lane's product rows: in registers (NX > 0, one row of NX floats a lane,
// zero padded to float4, loaded once per launch), else read in place from
// shared memory. dot() is dot4's sum, in dot4's order, either way.
template <int NX>
struct Row {
  static constexpr int PX = (NX + 3) & ~3;
  float m[PX];
  __device__ __forceinline__ float dot(const float* v, int) const {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int c = 0; c < PX; c += 4) {
      const float4 vv = reinterpret_cast<const float4*>(v)[c / 4];
      a0 = fmaf(m[c], vv.x, a0);
      a1 = fmaf(m[c + 1], vv.y, a1);
      a2 = fmaf(m[c + 2], vv.z, a2);
      a3 = fmaf(m[c + 3], vv.w, a3);
    }
    return (a0 + a1) + (a2 + a3);
  }
};
template <>
struct Row<0> {
  const float* s;
  __device__ __forceinline__ float dot(const float* v, int n4) const {
    return dot4(s, v, n4);
  }
};

// Acl[c][k] = A[c][k] - sum_q B[c][q] Kinf[q][k] of one instance, in a fixed
// order.
__device__ __forceinline__ float acl_entry(const float* A, const float* Bm,
                                           const float* K, int nx, int nu,
                                           int c, int k) {
  float a = A[c * nx + k];
  for (int q = 0; q < nu; ++q) a = fmaf(-Bm[c * nu + q], K[q * nx + k], a);
  return a;
}

// ----------------------------------------------------------------- kernel --

extern __shared__ float4 hstream_smem4[];

template <int NX, int NU, bool ADAPTIVE, bool CONES>
__global__ void __launch_bounds__(THREADS, NX > 0 ? 8 : 3)
    hstream_kernel(Args a) {
  constexpr bool COMPILED = NX > 0;
  const int G = COMPILED ? 16 : a.G;
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int Bn = a.Bn;
  // A warp past the batch has nothing to do (only __syncwarp below).
  if (blockIdx.x * a.ipb + (threadIdx.x & ~31) / G >= Bn) return;
  const int b = blockIdx.x * a.ipb + grp;
  const bool valid = b < Bn;
  const size_t bl = valid ? b : 0;  // a group past the batch reads instance 0
  const int nx = COMPILED ? NX : a.nx, nu = COMPILED ? NU : a.nu;
  const int N = a.N, m = N - 1, kb = a.kb;
  const int px = r4(nx), pu = r4(nu), tw = nx > nu ? nx : nu;
  const int px4 = px / 4, pu4 = pu / 4;
  const int nc = a.nc_u + a.nc_x;
  const int rows = nx + nu;
  const int rpl = COMPILED ? 1 : (rows + G - 1) / G;
  constexpr int R = COMPILED ? 1 : RMAX;
  const Layout L = make_layout(nx, nu, kb, nc, a.bk, COMPILED);
  float* S = reinterpret_cast<float*>(hstream_smem4) + grp * L.inst;
  ATM_CLK_BEGIN();

  // ------------------------------------------------------------ staging
  const float* A = a.A + bl * nx * nx;
  const float* Bm = a.Bm + bl * nx * nu;
  const float* K = a.K + bl * nu * nx;
  const float* Q = a.Quu + bl * nu * nu;
  const float* M = a.M + bl * nx * nx;
  for (int e = lane; e < L.ring; e += G) S[e] = 0.0f;
  __syncwarp();
  for (int e = lane; e < nx * nu; e += G) {
    const int c = e / nu, q = e - c * nu;   // B (nx, nu)
    S[L.TB + c * pu + q] = Bm[e];
    S[L.TK + c * pu + q] = K[q * nx + c];
  }
  for (int e = lane; e < nu * nu; e += G)
    S[L.TQ + (e / nu) * pu + e % nu] = Q[e];
  if (!COMPILED) {
    for (int e = lane; e < rows * nx; e += G) {
      const int j = e / nx, k = e - j * nx;
      if (j < nx) {
        S[L.R1 + j * px + k] = acl_entry(A, Bm, K, nx, nu, j, k);
        S[L.R2 + j * px + k] = M[j * nx + k];
      } else {
        S[L.R1 + j * px + k] = K[(j - nx) * nx + k];
        S[L.R2 + j * px + k] = Bm[k * nu + (j - nx)];
      }
    }
  }
  for (int e = lane; e < nx; e += G) {
    S[L.pt + e] = a.pterm[bl * nx + e];
    if (!a.bk) {
      S[L.xl + e] = a.xmin[bl * nx + e];
      S[L.xh + e] = a.xmax[bl * nx + e];
    }
  }
  if (!a.bk)
    for (int e = lane; e < nu; e += G) {
      S[L.ul + e] = a.umin[bl * nu + e];
      S[L.uh + e] = a.umax[bl * nu + e];
    }
  if (CONES) {
    // per cone: mu, shift, then each component's role (1 ball, 2 axis),
    // from the static table or this instance's rows of cparams / cmasks
    const int MR = 2 * nu * a.nc_u + 2 * nx * a.nc_x;
    for (int e = lane; e < nc * (2 + tw); e += G) {
      const int c = e / (2 + tw), k = e - c * (2 + tw);
      float val;
      if (k < 2) {
        val = a.cparams ? a.cparams[(bl * nc + c) * 2 + k]
                        : a.ctab[c * (2 + tw) + k];
      } else if (a.cmasks) {
        const bool in_u = c < a.nc_u;
        const int dim = in_u ? nu : nx, kk = k - 2;
        const int off = in_u ? 2 * nu * c
                             : 2 * nu * a.nc_u + 2 * nx * (c - a.nc_u);
        val = kk >= dim ? 0.0f
              : (a.cmasks[bl * MR + off + kk] != 0.0f ? 1.0f
                 : (a.cmasks[bl * MR + off + dim + kk] != 0.0f ? 2.0f
                                                              : 0.0f));
      } else {
        val = a.ctab[c * (2 + tw) + k];
      }
      S[L.cn + e] = val;
    }
  }
  Row<NX> R1, R2;
  if constexpr (COMPILED) {
    // lane j: state row j (j < NX) or input row j - NX; zero past them
#pragma unroll
    for (int k = 0; k < Row<NX>::PX; ++k) R1.m[k] = R2.m[k] = 0.0f;
    if (lane < NX) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        R1.m[k] = acl_entry(A, Bm, K, NX, NU, lane, k);
        R2.m[k] = M[lane * NX + k];
      }
    } else if (lane < NX + NU) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        R1.m[k] = K[(lane - NX) * NX + k];
        R2.m[k] = Bm[k * NU + (lane - NX)];
      }
    }
  }
  const float rho = a.rho[bl];
  __syncwarp();

  // this instance's rows of the streamed arrays (padded layouts)
  const size_t ou0 = bl * m * pu, ox0 = bl * N * px;
  float* ring = S + L.ring;
  const int rw = L.rw;

  // Piece p of a sweep's copies of a knot: the segments in order, their
  // 16-byte pieces numbered through (a group's lanes take p = lane, lane +
  // G, ...). Forward (fwd): d, y, the old z (res), g, the old v (res), the
  // bounds where they come per knot; backward: y, z, g, v from z/v or, after
  // a check (chk), zs/vs, and qc.
  auto piece = [&](int p, bool fwd, bool res, bool chk) {
    Copy c{nullptr, 0};
    auto seg = [&](bool on, int dst, const float* src, int stride, int n4,
                   int kind) {
      if (!on || c.meta) return;
      if (p < n4) c = make_copy(src + 4 * p, stride, dst + 4 * p, kind);
      else p -= n4;
    };
    if (fwd) {
      seg(true, L.oD, a.d + ou0, pu, pu4, 1);
      seg(true, L.oY, a.y + ou0, pu, pu4, 1);
      seg(res, L.oZ, a.z + ou0, pu, pu4, 1);
      seg(true, L.oG, a.g + ox0, px, px4, 0);
      seg(res, L.oV, a.v + ox0, px, px4, 0);
      seg(a.bk, L.oXL, a.xmin + ox0, px, px4, 0);
      seg(a.bk, L.oXH, a.xmax + ox0, px, px4, 0);
      seg(a.bk, L.oUL, a.umin + ou0, pu, pu4, 1);
      seg(a.bk, L.oUH, a.umax + ou0, pu, pu4, 1);
    } else {
      seg(true, L.oY, a.y + ou0, pu, pu4, 1);
      seg(true, L.oZ, (chk ? a.zs : a.z) + ou0, pu, pu4, 1);
      seg(true, L.oG, a.g + ox0, px, px4, 0);
      seg(true, L.oV, (chk ? a.vs : a.v) + ox0, px, px4, 0);
      seg(true, L.oQ, a.qc + ox0, px, px4, 2);
    }
    return c;
  };
  // A sweep's copies: a lane keeps its first two pieces from the start of
  // the sweep (at 12/4 a lane has at most two) and finds any further ones
  // (large run-time sizes) at each knot.
  Copy cps[2];
  bool more = false;
  auto plan = [&](bool fwd, bool res, bool chk) {
    cps[0] = piece(lane, fwd, res, chk);
    cps[1] = piece(lane + G, fwd, res, chk);
    more = !COMPILED && piece(lane + 2 * G, fwd, res, chk).meta != 0;
  };
  auto fetch = [&](int i, float* slot, bool fwd, bool res, bool chk) {
    issue(cps[0], i, m, slot);
    if (cps[1].meta) issue(cps[1], i, m, slot);
    if (more)
      for (int p = lane + 2 * G;; p += G) {
        const Copy c = piece(p, fwd, res, chk);
        if (!c.meta) break;
        issue(c, i, m, slot);
      }
  };

  // A row's place: state row k = j (isx) or input row k = j - nx; its
  // offsets in a ring entry (dual g or y, old slack v or z, bounds: in the
  // entry with per-knot bounds, else in the uniform rows), its stride per
  // knot in the streamed arrays and whether its box is enforced.
  struct RowAt {
    int j, k, rd, rs, rl, rh, st;
    bool isx, en;
  };
  auto row_at = [&](int j) {
    RowAt r;
    r.j = j;
    r.isx = j < nx;
    r.k = r.isx ? j : j - nx;
    r.rd = (r.isx ? L.oG : L.oY) + r.k;
    r.rs = (r.isx ? L.oV : L.oZ) + r.k;
    r.rl = (a.bk ? (r.isx ? L.oXL : L.oUL) : (r.isx ? L.xl : L.ul)) + r.k;
    r.rh = (a.bk ? (r.isx ? L.oXH : L.oUH) : (r.isx ? L.xh : L.uh)) + r.k;
    r.st = r.isx ? px : pu;
    r.en = r.isx ? a.en_sb : a.en_ib;
    return r;
  };
  const RowAt r0 = row_at(lane);   // the compiled body's one row a lane

  // this instance's streamed arrays (offsets inside an instance fit 32 bits)
  float* const gI = a.g + ox0;
  float* const vI = a.v + ox0;
  float* const vsI = a.vs + ox0;
  float* const yI = a.y + ou0;
  float* const zI = a.z + ou0;
  float* const zsI = a.zs + ou0;
  float* const dI = a.d + ou0;
  float* const XI = a.X + bl * N * nx;   // U and X unpadded
  float* const UI = a.U + bl * m * nu;

  // Forward: rollout fused with the slack projection, cones and dual
  // update, knot by knot. live: this group computes and stores; res: take
  // the residuals (old slacks from the ring); chk: new slacks to zs/vs;
  // emit: store U and X.
  float rpx = 0.0f, rdx = 0.0f, rpu = 0.0f, rdu = 0.0f;
  auto forward = [&](bool live, bool res, bool chk, bool emit) {
    float* const vdst = chk ? vsI : vI;
    float* const zdst = chk ? zsI : zI;
    rpx = rdx = rpu = rdu = 0.0f;
    plan(true, res, chk);
    __syncwarp();
    if (live)
      for (int j = lane; j < nx; j += G) S[L.xs + j] = a.x0[bl * nx + j];
    int fs = 0, cs = 0;   // ring entries: the next to fill, to compute on
    for (int t = 0; t < kb - 1; ++t) {   // the first kb - 1 knots ahead
      if (live && t <= m) fetch(t, ring + fs * rw, true, res, chk);
      cp_commit();
      ++fs;
    }
    ATM_CLK(6);
    // residuals, dual ascent and the new slack of one row
    auto finish = [&](const RowAt& r, int i, const float* e, float pre,
                      float tsum, float s) {
      if (res) {
        const float dp = fabsf(pre - s), dd = fabsf(e[r.rs] - s);
        rpx = r.isx ? nanmax(rpx, dp) : rpx;
        rdx = r.isx ? nanmax(rdx, dd) : rdx;
        rpu = r.isx ? rpu : nanmax(rpu, dp);
        rdu = r.isx ? rdu : nanmax(rdu, dd);
      }
      const int o = i * r.st + r.k;
      (r.isx ? gI : yI)[o] = tsum - s;
      (r.isx ? vdst : zdst)[o] = s;
    };
    for (int i = 0; i <= m; ++i) {
      cp_wait(kb - 2);                    // knot i has arrived here,
      __syncwarp();                       // and from every lane; x_i too
      ATM_CLK(1);
      if (live && i + kb - 1 <= m)        // the knot kb - 1 ahead, into the
        fetch(i + kb - 1, ring + fs * rw, true, res, chk);  // entry of i - 1
      cp_commit();
      fs = fs + 1 == kb ? 0 : fs + 1;
      ATM_CLK(0);
      const float* e = ring + cs * rw;
      cs = cs + 1 == kb ? 0 : cs + 1;
      const float* xc = S + L.xs + (i & 1) * px;
      float* xn = S + L.xs + ((i + 1) & 1) * px;
      const float* lb = a.bk ? e : S;
      float pre_[R], tsum_[R];
      if (live) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int j = lane + t * G;
          if (t >= rpl || j >= rows) break;
          const RowAt r = COMPILED ? r0 : row_at(j);
          if (!r.isx && i == m) continue;
          const float acc =
              COMPILED ? R1.dot(xc, px4)
                       : Row<0>{S + L.R1 + j * px}.dot(xc, px4);
          // the chain first: x_{i+1} = Acl x_i - B d_i
          if (r.isx && i < m)
            xn[r.k] = acc - dot4(S + L.TB + r.k * pu, e + L.oD, pu4);
          const float v1 = *(r.isx ? xc + r.k : e + L.oD + r.k);
          const float pre = r.isx ? v1 : -acc - v1;  // x_i, or u_i
          const float tsum = pre + e[r.rd];
          const float s = r.en ? clip(tsum, lb[r.rl], lb[r.rh]) : tsum;
          if (emit) (r.isx ? XI + i * nx : UI + i * nu)[r.k] = pre;
          if (CONES && nc > 0) {
            pre_[t] = pre;
            tsum_[t] = tsum;
            S[L.sl + (r.isx ? 0 : px) + r.k] = s;
          } else {
            finish(r, i, e, pre, tsum, s);
          }
        }
      }
      if (CONES && nc > 0) {
        // cones in order on the knot's slacks (solver/cones.py): every lane
        // takes a cone's norm over the whole vector, the owners update
        __syncwarp();
        for (int c = 0; c < nc; ++c) {
          const bool in_u = c < a.nc_u;
          if (in_u && i == m) continue;
          const float* row = S + L.cn + c * (2 + tw);
          const float* w = S + L.sl + (in_u ? px : 0);
          const int dim = in_u ? nu : nx;
          float scale = 1.0f, s_new = 0.0f;
          if (live) {
            const float mu = row[0], sh = row[1];
            float a2 = 0.0f, sx = 0.0f;
            for (int k = 0; k < dim; ++k) {
              const float role = row[2 + k];
              if (role == 1.0f) a2 = fmaf(w[k], w[k], a2);
              if (role == 2.0f) sx = w[k];
            }
            const float sv = sx + sh;
            const float an = sqrtf(a2);
            const bool inside = an <= mu * sv;
            const bool polar = mu * an <= -sv;
            const float cc = (mu * an + sv) / (mu * mu + 1.0f);
            const float safe_a = a2 == 0.0f ? an + 1.0f : an;
            scale = inside ? 1.0f : (polar ? 0.0f : mu * cc / safe_a);
            s_new = (inside ? sv : (polar ? 0.0f : cc)) - sh;
          }
          __syncwarp();
          if (live) {
#pragma unroll
            for (int t = 0; t < R; ++t) {
              const int j = lane + t * G;
              if (t >= rpl || j >= rows) break;
              const bool isx = j < nx;
              if (isx == in_u) continue;
              const int k = isx ? j : j - nx;
              const float role = row[2 + k];
              float* wk = S + L.sl + (isx ? 0 : px) + k;
              *wk = role == 1.0f ? *wk * scale
                    : (role == 2.0f ? s_new : *wk);
            }
          }
          __syncwarp();
        }
        if (live) {
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int j = lane + t * G;
            if (t >= rpl || j >= rows) break;
            const RowAt r = COMPILED ? r0 : row_at(j);
            if (!r.isx && i == m) continue;
            finish(r, i, e, pre_[t], tsum_[t],
                   S[L.sl + (r.isx ? 0 : px) + r.k]);
          }
        }
      }
      ATM_CLK(2);
      ATM_CLK_COUNT(7);
    }
    cp_wait(0);
    if (res) {   // group maxima (uniform over the warp: res is)
      for (int o = G / 2; o > 0; o >>= 1) {
        rpx = nanmax(rpx, __shfl_xor_sync(FULL, rpx, o, G));
        rdx = nanmax(rdx, __shfl_xor_sync(FULL, rdx, o, G));
        rpu = nanmax(rpu, __shfl_xor_sync(FULL, rpu, o, G));
        rdu = nanmax(rdu, __shfl_xor_sync(FULL, rdu, o, G));
      }
    }
  };

  // Backward gradient recursion (reference admm.cpp:15-22 with the
  // linear-cost refresh :77-85) from the slacks in z/v, or in zs/vs after a
  // check (chk), which it then moves to z/v. live: this group computes and
  // writes D.
  auto backward = [&](bool live, bool chk) {
    plan(false, false, chk);
    __syncwarp();
    int fs = 0, cs = 0;
    for (int t = 0; t < kb - 1; ++t) {
      if (live && t <= m) fetch(m - t, ring + fs * rw, false, false, chk);
      cp_commit();
      ++fs;
    }
    ATM_CLK(6);
    for (int t = 0; t <= m; ++t) {
      const int i = m - t;
      cp_wait(kb - 2);
      __syncwarp();                       // knot i, p_{i+1} and w_{i+1}
      ATM_CLK(4);
      if (live && t + kb - 1 <= m)
        fetch(m - (t + kb - 1), ring + fs * rw, false, false, chk);
      cp_commit();
      fs = fs + 1 == kb ? 0 : fs + 1;
      ATM_CLK(3);
      const float* e = ring + cs * rw;
      cs = cs + 1 == kb ? 0 : cs + 1;
      const float* pc = S + L.ps + (t & 1) * px;
      float* pn = S + L.ps + ((t + 1) & 1) * px;
      const float* wc = S + L.ws + (t & 1) * pu;
      float* wn = S + L.ws + ((t + 1) & 1) * pu;
      if (live) {
#pragma unroll
        for (int tt = 0; tt < R; ++tt) {
          const int j = lane + tt * G;
          if (tt >= rpl || j >= rows) break;
          const RowAt r = COMPILED ? r0 : row_at(j);
          const int k = r.k;
          const int o = i * r.st + k;
          // AmBKt p_{i+1} (a state row) or B' p_{i+1} (an input row)
          const float acc =
              COMPILED ? R2.dot(pc, px4)
                       : Row<0>{S + L.R2 + j * px}.dot(pc, px4);
          if (r.isx) {
            const float gv = e[L.oV + k] - e[L.oG + k];
            if (t == 0) {             // terminal costate
              pn[k] = S[L.pt + k] - rho * gv;
            } else if (i > 0) {
              // Kinf' r with r = -rho (z - y), from the knot's copy
              const float* kt = S + L.TK + k * pu;
              float k0 = 0.0f, k1 = 0.0f, k2 = 0.0f, k3 = 0.0f;
              for (int c = 0; c < pu4; ++c) {
                const float4 w4 = reinterpret_cast<const float4*>(kt)[c];
                const float4 z4 =
                    reinterpret_cast<const float4*>(e + L.oZ)[c];
                const float4 y4 =
                    reinterpret_cast<const float4*>(e + L.oY)[c];
                k0 = fmaf(w4.x, -rho * (z4.x - y4.x), k0);
                k1 = fmaf(w4.y, -rho * (z4.y - y4.y), k1);
                k2 = fmaf(w4.z, -rho * (z4.z - y4.z), k2);
                k3 = fmaf(w4.w, -rho * (z4.w - y4.w), k3);
              }
              const float q = e[L.oQ + k] - rho * gv;
              pn[k] = (q + acc) - ((k0 + k1) + (k2 + k3));
            }
          } else {
            if (t >= 2)    // d_{i+1} = Quu_inv w_{i+1}
              dI[o + pu] = dot4(S + L.TQ + k * pu, wc, pu4);
            if (t >= 1) wn[k] = acc + -rho * (e[L.oZ + k] - e[L.oY + k]);
          }
          if (chk && (r.isx || t >= 1))   // the new slacks to z/v
            (r.isx ? vI : zI)[o] = e[r.rs];
        }
      }
      ATM_CLK(5);
      ATM_CLK_COUNT(8);
    }
    cp_wait(0);
    __syncwarp();                         // w_0
    if (live) {
      const float* w0 = S + L.ws + ((m + 1) & 1) * pu;
      for (int j = lane; j < rows; j += G)
        if (j >= nx) dI[j - nx] = dot4(S + L.TQ + (j - nx) * pu, w0, pu4);
    }
  };

  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = (float)a.max_iter, solved = 0.0f;
  if (!ADAPTIVE) {
    // Fixed: max_iter iterations, slacks in place; the last one's residuals
    // compare the final slacks with the penultimate ones.
    for (int it = 0; it < a.max_iter; ++it) {
      const bool last = it == a.max_iter - 1;
      forward(valid, last, false, valid && last);
      if (last) {
        r[0] = rpx; r[1] = rho * rdx; r[2] = rpu; r[3] = rho * rdu;
      }
      backward(valid, false);
      ATM_CLK(6);
      ATM_CLK_COUNT(9);
    }
  } else {
    // Adaptive: a check at every in-call iteration kc that is a multiple of
    // check_every; residual stats are the last live check's.
    bool done = !valid;
    for (int k = 0; k < a.max_iter && __any_sync(FULL, !done); ++k) {
      const int kc = k + 1;
      const bool chk = kc % a.check_every == 0;
      const bool live = !done;
      forward(live, chk, chk, live && (chk || kc == a.max_iter));
      bool newly = false;
      if (chk && live) {
        r[0] = rpx; r[1] = rho * rdx; r[2] = rpu; r[3] = rho * rdu;
        newly = r[0] < a.pri_tol && r[2] < a.pri_tol && r[1] < a.dua_tol &&
                r[3] < a.dua_tol;
      }
      const bool cont = live && !newly;
      if (__any_sync(FULL, cont)) backward(cont, chk);
      if (newly) {
        done = true;
        iters = (float)kc;
        solved = 1.0f;
      }
      ATM_CLK(6);
      ATM_CLK_COUNT(9);
    }
  }

  ATM_CLK_END();
  if (valid && lane == 0) {
    float* st = a.stats + bl * 8;
    st[0] = iters; st[1] = solved;
    st[2] = r[0]; st[3] = r[1]; st[4] = r[2]; st[5] = r[3];
    st[6] = 0.0f; st[7] = 0.0f;
  }
}

// ------------------------------------------------------------------ launch --

using Kernel = void (*)(Args);

template <int NX, int NU>
static Kernel pick_mode(bool adaptive, bool coned) {
  return adaptive ? (coned ? hstream_kernel<NX, NU, true, true>
                           : hstream_kernel<NX, NU, true, false>)
                  : (coned ? hstream_kernel<NX, NU, false, true>
                           : hstream_kernel<NX, NU, false, false>);
}

static Kernel pick(int nx, int nu, bool adaptive, bool coned) {
  if (nx == 12 && nu == 4) return pick_mode<12, 4>(adaptive, coned);
  if (nx == 8 && nu == 3) return pick_mode<8, 3>(adaptive, coned);
  return adaptive ? (coned ? hstream_kernel<0, 0, true, true>
                           : hstream_kernel<0, 0, true, false>)
                  : (coned ? hstream_kernel<0, 0, false, true>
                           : hstream_kernel<0, 0, false, false>);
}

// Dynamic shared memory of one block of `threads` threads.
static int block_bytes(int nx, int nu, int kb, int nc, int bk, int threads) {
  return threads / group_lanes(nx, nu) *
         make_layout(nx, nu, kb, nc, bk, compiled_shape(nx, nu)).inst * 4;
}

}  // namespace atm_stream

extern "C" {

// Blocks an SM holds at once for a launch of these sizes, or a negative
// CUDA error / -1.
int atm_hstream_resident(int nx, int nu, int kb, int nc, int bk,
                         int adaptive, int threads) {
  using namespace atm_stream;
  const int smem = block_bytes(nx, nu, kb, nc, bk, threads);
  Kernel kernel = pick(nx, nu, adaptive != 0, nc > 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  return err == cudaSuccess ? n : -(int)err;
}

// One batched long-horizon solve, a plant per instance (K11/K12): A, B, K,
// Quu, M (Bn, ...), pterm (Bn, nx), rho (Bn), x0 (Bn, nx). The carry d, y,
// z (and zs) are (Bn, N-1, r4(nu)), g, v (and vs) and qc (Bn, N, r4(nx)):
// each knot's row padded to a multiple of 4 floats, 16-byte aligned, the
// padding zero; the carry is updated in place. U (Bn, N-1, nu), X (Bn, N,
// nx). Bounds: bound_knot 0, one row per instance (umin (Bn, nu), xmin
// (Bn, nx)); 1, a padded row per knot (umin like d, xmin like g).
// check_every == 0: fixed max_iter iterations (K11); > 0: the adaptive
// kernel (K12), which needs zs and vs. cone_tab == nullptr: no cones;
// otherwise the device table of nc_u input and nc_x state cones (rows of 2
// + max(nx, nu): mu, shift, each component's role); cparams (Bn, nc, 2) and
// cmasks (Bn, MR) are per-instance values or nullptr. kb (2..8): knots a
// group keeps in flight; threads per block; smem_bytes must equal the
// layout's count (make_layout; ops/stream_admm.py hstream_smem_bytes).
int atm_stream_solve(
    const float* x0, const float* A, const float* Bm,
    const float* K, const float* Quu, const float* M, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* qc,
    const float* pterm, const float* rho,
    float* U, float* X, float* d, float* y, float* g, float* z, float* v,
    float* zs, float* vs, float* stats,
    const float* cone_tab, int nc_u, int nc_x, const float* cparams,
    const float* cmasks, int bound_knot,
    int Bn, int nx, int nu, int N, int max_iter, int check_every, int en_ib,
    int en_sb, float pri_tol, float dua_tol, int kb, int threads,
    int smem_bytes, void* stream) {
  using namespace atm_stream;
  const int G = group_lanes(nx, nu);
  const int nc = nc_u + nc_x;
  if (Bn <= 0 || nx < 1 || nu < 1 || N < 2 || max_iter < 1 ||
      check_every < 0 || bound_knot < 0 || bound_knot > 1 || kb < 2 ||
      kb > KB_MAX || threads < 32 || threads > THREADS || threads % 32 ||
      threads % G || (nx + nu + G - 1) / G > RMAX || nc_u < 0 ||
      nc_x < 0 || (nc > 0) != (cone_tab != nullptr) ||
      (nc == 0 && (cparams != nullptr || cmasks != nullptr)) ||
      (check_every > 0 && (zs == nullptr || vs == nullptr)) ||
      smem_bytes != block_bytes(nx, nu, kb, nc, bound_knot, threads))
    return -1;
  Args a = {};
  a.x0 = x0; a.A = A; a.Bm = Bm; a.K = K; a.Quu = Quu; a.M = M;
  a.umin = umin; a.umax = umax; a.xmin = xmin; a.xmax = xmax;
  a.qc = qc; a.pterm = pterm; a.rho = rho;
  a.U = U; a.X = X; a.d = d; a.y = y; a.g = g; a.z = z; a.v = v;
  a.zs = zs ? zs : z; a.vs = vs ? vs : v;
  a.stats = stats;
  a.cparams = cparams; a.cmasks = cmasks; a.ctab = cone_tab;
  a.bk = bound_knot;
  a.Bn = Bn; a.nx = nx; a.nu = nu; a.N = N; a.max_iter = max_iter;
  a.check_every = check_every; a.en_ib = en_ib; a.en_sb = en_sb;
  a.kb = kb; a.G = G; a.ipb = threads / G;
  a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  a.nc_u = nc_u; a.nc_x = nc_x;
  Kernel kernel = pick(nx, nu, check_every > 0, nc > 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Bn + a.ipb - 1) / a.ipb;
  kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
