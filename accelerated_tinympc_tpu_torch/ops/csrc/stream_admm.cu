// Long-horizon ADMM kernels for Hopper (sm_90a), FP32, one distinct plant
// per instance: the iterates stream through global memory knot by knot.
//
//   stream_kernel<G, false, *>  replaces accelerated_tinympc_tpu/ops/
//                               hstream_admm.py _kernel (fixed iterations)
//   stream_kernel<G, true, *>   replaces hstream_admm.py _kernel_adaptive
//                               (per-instance early exit)
// (the third parameter: with cone code, or none at all)
//
// (The shared-plant kernels K9/K10 are csrc/stream_shared.cu.)
//
// What bounds it: memory traffic. At N in the hundreds to thousands one
// instance's iterates (d, y, z: (N-1) nu; g, v: N nx floats) take ~100 KB at
// nx=8, nu=3, N=1024; a batch of thousands is far larger than the L2 and the
// shared memory, so every iteration reads and writes them in global memory:
// the forward sweep reads d, y, g and writes y, z, g, v; the backward sweep
// reads y, z, g, v and qc and writes d (7 nu + 6 nx floats per knot and
// iteration), against 2 (4 nx nu + 2 nx^2 + nu^2) FLOP.
//
// Design. The layout is the port's own, batch-leading and unpadded
// (d (B, N-1, nu), g (B, N, nx), ...), so the design is the hetero kernel's
// (csrc/hetero_admm.cu): a group of G = pow2 >= max(nx, nu) lanes owns one
// instance and lane i keeps row i of A, AmBKt, B and Kinf' (lanes j < nu rows
// of Kinf, B' and Quu_inv) in registers; products broadcast the vector with
// __shfl_sync. Per knot the group reads and writes its instance's nx or nu
// contiguous floats. Bounds are uniform rows or per-knot schedules, shared
// or per instance, by their strides. Cones (any number): mu, shift and each
// lane's role per cone in the group's slice of dynamic shared memory.
//  * x, u and p are sweep carries; U and X are written only where they are
//    the result: on the last iteration (fixed mode), and in adaptive mode on
//    every check iteration and the last one, while the instance is live.
//  * The forward sweep fuses rollout, box clip, cones and dual update knot by
//    knot; the backward sweep rebuilds r = -rho (z - y) and q = qc - rho (v -
//    g) from the post-update slacks (reference admm.cpp:77-85 before :15-22).
//  * Fixed mode updates the slacks in place; the last iteration reads the
//    old ones for the residuals before it writes the new ones.
//  * Adaptive mode: convergence is known only after the whole forward sweep,
//    so the new slacks go to the other of two buffers (z/zs, v/vs, per
//    instance parity); an instance that converges keeps the old ones
//    (pre-save Z, V), skips the backward pass (pre-backward D) and stops
//    writing. A warp runs until all its groups are done. At the end an
//    instance whose current slacks sit in zs/vs copies them to z/v.
//  * The kernel stages nothing: knot_block of the JAX kernel (knots per DMA
//    block) has no counterpart, and results do not depend on it.
//  * An instance's arithmetic does not depend on its place in the batch, so
//    a compacted re-launch continues it bit for bit.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError(), or -1 for sizes out of range. The carry arrays d, y, g,
// z, v are updated in place (the caller passes copies of the warm start).

#include <cuda_runtime.h>

#include "group_ops.cuh"

namespace atm_stream {

using namespace atm_group;

constexpr int MAXDIM = 32;
constexpr int THREADS = 128;

struct Args {
  const float *x0, *A, *Bm, *K, *Quu, *M;
  const float *umin, *umax, *xmin, *xmax, *qc, *pterm, *rho;
  float *U, *X, *d, *y, *g, *z, *v, *zs, *vs, *stats;
  const float *cparams, *cmasks;  // (Bn, nc, 2), (Bn, MR) or null
  const float* ctab;              // static cone table (group_ops.cuh)
  int bi, bk;                     // bounds per instance, per knot
  int Bn, nx, nu, N, max_iter, check_every, en_ib, en_sb;
  float pri_tol, dua_tol;
  int nc_u, nc_x;
};

// One instance: matrix rows in registers, pointers to its streamed rows.
template <int G>
struct Inst {
  float Ar[G], Mr[G], Br[G], Ktr[G];  // lane < nx: rows of A, AmBKt, B, Kinf'
  float Kr[G], Btr[G], Qr[G];         // lane < nu: rows of Kinf, B', Quu_inv
  float x0, pt, rho;
  const float *Qc, *XL, *XH, *UL, *UH;
  float *X, *V0, *V1, *Gd, *U, *Z0, *Z1, *Y, *D;  // buffers 0/1 by parity
  const float* CP;  // mu, shift per cone, then the lanes' roles
};

// Forward rollout fused with the slack projection, cones and dual update,
// knot by knot; new slacks into buffer `wn`, old ones read from `ro` (in
// place in fixed mode: ro == wn, read before written). `res`: the residual
// maxima of this iteration (reference admm.cpp:95-98, dual ones without rho)
// come back group-reduced. `wr`: store y, g and the new slacks; `wux`: store
// U and X.
template <int G, bool CONES>
__device__ inline void forward(const Args& a, Inst<G>& s, int lane, int ro,
                               int wn, bool res, bool wr, bool wux,
                               float r[4]) {
  const int nx = a.nx, nu = a.nu, m = a.N - 1;
  const bool lx = lane < nx, lu = lane < nu;
  const float* Vo = ro ? s.V1 : s.V0;
  const float* Zo = ro ? s.Z1 : s.Z0;
  float* Vn = wn ? s.V1 : s.V0;
  float* Zn = wn ? s.Z1 : s.Z0;
  const int bk = a.bk;
  float ps = 0.0f, ds = 0.0f, pu = 0.0f, du = 0.0f;
  float xi = s.x0;
  for (int i = 0; i <= m; ++i) {
    const int ex = i * nx + lane;
    const float tx = xi + (lx ? s.Gd[ex] : 0.0f);
    float vn = (a.en_sb && lx) ? clip(tx, s.XL[i * bk * nx + lane],
                                      s.XH[i * bk * nx + lane]) : tx;
    if (CONES && a.nc_x)
      vn = cones<G>(lx ? vn : 0.0f, a.nc_u, a.nc_x,
                    s.CP + 2 * (a.nc_u + a.nc_x), s.CP, lane);
    if (lx) {
      if (res) {
        ps = nanmax(ps, fabsf(xi - vn));
        ds = nanmax(ds, fabsf(Vo[ex] - vn));
      }
      if (wr) {
        Vn[ex] = vn;
        s.Gd[ex] = tx - vn;
      }
      if (wux) s.X[ex] = xi;
    }
    if (i == m) break;
    const int eu = i * nu + lane;
    const float u = -dot<G>(s.Kr, xi) - (lu ? s.D[eu] : 0.0f);
    const float su = u + (lu ? s.Y[eu] : 0.0f);
    float zn = (a.en_ib && lu) ? clip(su, s.UL[i * bk * nu + lane],
                                      s.UH[i * bk * nu + lane]) : su;
    if (CONES && a.nc_u)
      zn = cones<G>(lu ? zn : 0.0f, 0, a.nc_u, s.CP + 2 * (a.nc_u + a.nc_x),
                    s.CP, lane);
    if (lu) {
      if (res) {
        pu = nanmax(pu, fabsf(u - zn));
        du = nanmax(du, fabsf(Zo[eu] - zn));
      }
      if (wr) {
        Zn[eu] = zn;
        s.Y[eu] = su - zn;
      }
      if (wux) s.U[eu] = u;
    }
    xi = dot<G>(s.Ar, xi) + dot<G>(s.Br, u);
  }
  if (res) {
    r[0] = gmax<G>(ps);
    r[1] = gmax<G>(ds);
    r[2] = gmax<G>(pu);
    r[3] = gmax<G>(du);
  }
}

// Backward gradient recursion from the slacks in buffer `wn` (reference
// admm.cpp:15-22 with the linear-cost refresh :77-85); writes D with `wr`.
template <int G>
__device__ inline void backward(const Args& a, Inst<G>& s, int lane, int wn,
                                bool wr) {
  const int nx = a.nx, nu = a.nu, m = a.N - 1;
  const bool lx = lane < nx, lu = lane < nu;
  const float* Vn = wn ? s.V1 : s.V0;
  const float* Zn = wn ? s.Z1 : s.Z0;
  float p = 0.0f;
  if (lx) {
    const int e = m * nx + lane;
    p = s.pt - s.rho * (Vn[e] - s.Gd[e]);
  }
  for (int i = m - 1; i >= 0; --i) {
    const int eu = i * nu + lane;
    const float r = lu ? -s.rho * (Zn[eu] - s.Y[eu]) : 0.0f;
    const float w = dot<G>(s.Btr, p) + r;
    const float di = dot<G>(s.Qr, w);
    if (lu && wr) s.D[eu] = di;
    if (i > 0) {
      const int e = i * nx + lane;
      const float q = lx ? s.Qc[e] - s.rho * (Vn[e] - s.Gd[e]) : 0.0f;
      p = q + dot<G>(s.Mr, p) - dot<G>(s.Ktr, r);
    }
  }
}

extern __shared__ float stream_smem[];

template <int G, bool ADAPTIVE, bool CONES>
__global__ void __launch_bounds__(THREADS) stream_kernel(Args a) {
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int b = blockIdx.x * (THREADS / G) + grp;
  const bool valid = b < a.Bn;
  const size_t bl = valid ? b : 0;   // a group past the batch reads instance 0
  const int nx = a.nx, nu = a.nu, N = a.N, m = N - 1;
  const int nc = a.nc_u + a.nc_x;
  const size_t XN = (size_t)N * nx, UM = (size_t)m * nu;
  const bool lx = lane < nx, lu = lane < nu;

  Inst<G> s;
  s.X = a.X + bl * XN; s.V0 = a.v + bl * XN; s.V1 = a.vs + bl * XN;
  s.Gd = a.g + bl * XN; s.Qc = a.qc + bl * XN;
  // Bounds: uniform rows or a row per knot, shared or per instance.
  const size_t bx = a.bi ? bl * (a.bk ? N : 1) * nx : 0;
  const size_t bu = a.bi ? bl * (a.bk ? m : 1) * nu : 0;
  s.XL = a.xmin + bx; s.XH = a.xmax + bx;
  s.U = a.U + bl * UM; s.Z0 = a.z + bl * UM; s.Z1 = a.zs + bl * UM;
  s.Y = a.y + bl * UM; s.D = a.d + bl * UM;
  s.UL = a.umin + bu; s.UH = a.umax + bu;
  float* cp = stream_smem + grp * (2 + G) * nc;
  float* cr = cp + 2 * nc;
  if (CONES)
    load_cones<G>(a.ctab, nx > nu ? nx : nu, a.nc_u, a.nc_x, nx, nu,
                a.cparams, a.cmasks, bl, lane, cp, cr);
  s.CP = cp;
  // Matrix rows into registers.
#pragma unroll
  for (int k = 0; k < G; ++k) {
    s.Ar[k] = (lx && k < nx) ? a.A[(bl * nx + lane) * nx + k] : 0.0f;
    s.Mr[k] = (lx && k < nx) ? a.M[(bl * nx + lane) * nx + k] : 0.0f;
    s.Br[k] = (lx && k < nu) ? a.Bm[(bl * nx + lane) * nu + k] : 0.0f;
    s.Ktr[k] = (lx && k < nu) ? a.K[(bl * nu + k) * nx + lane] : 0.0f;
    s.Kr[k] = (lu && k < nx) ? a.K[(bl * nu + lane) * nx + k] : 0.0f;
    s.Btr[k] = (lu && k < nx) ? a.Bm[(bl * nx + k) * nu + lane] : 0.0f;
    s.Qr[k] = (lu && k < nu) ? a.Quu[(bl * nu + lane) * nu + k] : 0.0f;
  }
  s.x0 = lx ? a.x0[bl * nx + lane] : 0.0f;
  s.pt = lx ? a.pterm[bl * nx + lane] : 0.0f;
  s.rho = a.rho[bl];
  __syncwarp();

  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = (float)a.max_iter, solved = 0.0f;
  int par = 0;
  if (!ADAPTIVE) {
    // Fixed: max_iter iterations, slacks in place; the last one's residuals
    // compare the final slacks with the penultimate ones.
    for (int it = 0; it < a.max_iter; ++it) {
      const bool last = it == a.max_iter - 1;
      forward<G, CONES>(a, s, lane, 0, 0, last, valid, valid && last, r);
      backward<G>(a, s, lane, 0, valid);
    }
    r[1] *= s.rho;
    r[3] *= s.rho;
  } else {
    // Adaptive: a check at every in-call iteration kc that is a multiple of
    // check_every; residual stats are the last live check's.
    bool done = !valid;
    for (int k = 0; k < a.max_iter && __any_sync(FULL, !done); ++k) {
      const int kc = k + 1;
      const bool chk = kc % a.check_every == 0;
      const bool live = !done;
      float rr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      forward<G, CONES>(a, s, lane, par, par ^ 1, chk, live,
                 live && (chk || kc == a.max_iter), rr);
      bool newly = false;
      if (chk && live) {
        r[0] = rr[0];
        r[1] = s.rho * rr[1];
        r[2] = rr[2];
        r[3] = s.rho * rr[3];
        newly = r[0] < a.pri_tol && r[2] < a.pri_tol && r[1] < a.dua_tol &&
                r[3] < a.dua_tol;
      }
      const bool cont = live && !newly;
      backward<G>(a, s, lane, par ^ 1, cont);
      if (cont) par ^= 1;
      if (newly) {
        done = true;
        iters = (float)kc;
        solved = 1.0f;
      }
    }
  }

  if (!valid) return;
  if (ADAPTIVE && par) {  // the current slacks sit in the scratch buffers
    for (size_t e = lane; e < XN; e += G) s.V0[e] = s.V1[e];
    for (size_t e = lane; e < UM; e += G) s.Z0[e] = s.Z1[e];
  }
  if (lane == 0) {
    float* st = a.stats + bl * 8;
    st[0] = iters; st[1] = solved;
    st[2] = r[0]; st[3] = r[1]; st[4] = r[2]; st[5] = r[3];
    st[6] = 0.0f; st[7] = 0.0f;
  }
}

// Dynamic shared memory of one block: per group mu, shift and the lanes'
// roles per cone.
__host__ __device__ inline int smem_bytes(int G, int nc) {
  return (THREADS / G) * (2 + G) * nc * 4;
}

template <int G>
static int launch_g(const Args& a, cudaStream_t stream) {
  constexpr int ipb = THREADS / G;
  const int blocks = (a.Bn + ipb - 1) / ipb;
  const int smem = smem_bytes(G, a.nc_u + a.nc_x);
  const bool coned = a.nc_u + a.nc_x > 0;   // else no cone code at all
  auto kernel = a.check_every > 0
      ? (coned ? stream_kernel<G, true, true> : stream_kernel<G, true, false>)
      : (coned ? stream_kernel<G, false, true>
               : stream_kernel<G, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch(const Args& a, int G, cudaStream_t stream) {
  switch (G) {
    case 4: return launch_g<4>(a, stream);
    case 8: return launch_g<8>(a, stream);
    case 16: return launch_g<16>(a, stream);
    default: return launch_g<32>(a, stream);
  }
}

}  // namespace atm_stream

extern "C" {

// One batched long-horizon solve, a plant per instance (K11/K12): A, B, K,
// Quu, M, qc (Bn, N, nx), pterm (Bn, nx), rho (Bn). Bounds (umin, umax, ...):
// bound_inst 1 for a set per instance (0: shared), bound_knot 1 for a row per
// knot (0: one uniform row). check_every == 0: fixed max_iter iterations; >
// 0: the adaptive kernel, which needs zs (Bn, N-1, nu) and vs (Bn, N, nx)
// scratch. cone_tab == nullptr: no cones; otherwise the device table of nc_u
// input and nc_x state cones (group_ops.cuh load_cones, rows of 2 + max(nx,
// nu) floats); cparams (Bn, nc, 2) and cmasks (Bn, MR) are device arrays of
// per-instance values or nullptr.
int atm_stream_solve(
    const float* x0, const float* A, const float* Bm,
    const float* K, const float* Quu, const float* M, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* qc,
    const float* pterm, const float* rho,
    float* U, float* X, float* d, float* y, float* g, float* z, float* v,
    float* zs, float* vs, float* stats,
    const float* cone_tab, int nc_u, int nc_x, const float* cparams,
    const float* cmasks, int bound_inst, int bound_knot,
    int Bn, int nx, int nu, int N, int max_iter, int check_every, int en_ib,
    int en_sb, float pri_tol, float dua_tol, void* stream) {
  using namespace atm_stream;
  if (Bn <= 0 || nx < 1 || nx > MAXDIM || nu < 1 || nu > MAXDIM || N < 2 ||
      max_iter < 1 || check_every < 0 || bound_inst < 0 || bound_inst > 1 ||
      bound_knot < 0 || bound_knot > 1 ||
      (check_every > 0 && (zs == nullptr || vs == nullptr)))
    return -1;
  Args a = {};
  a.x0 = x0; a.A = A; a.Bm = Bm; a.K = K; a.Quu = Quu; a.M = M;
  a.umin = umin; a.umax = umax; a.xmin = xmin; a.xmax = xmax;
  a.qc = qc; a.pterm = pterm; a.rho = rho;
  a.U = U; a.X = X; a.d = d; a.y = y; a.g = g; a.z = z; a.v = v;
  a.zs = zs ? zs : z; a.vs = vs ? vs : v;
  a.stats = stats;
  a.cparams = cparams; a.cmasks = cmasks;
  a.bi = bound_inst; a.bk = bound_knot;
  a.Bn = Bn; a.nx = nx; a.nu = nu; a.N = N; a.max_iter = max_iter;
  a.check_every = check_every; a.en_ib = en_ib; a.en_sb = en_sb;
  a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  if (cone_tab != nullptr) {
    if (nc_u < 0 || nc_x < 0 || nc_u + nc_x < 1) return -1;
    a.ctab = cone_tab;
    a.nc_u = nc_u;
    a.nc_x = nc_x;
  } else if (cparams != nullptr || cmasks != nullptr) {
    return -1;
  }
  int G = 4;
  while (G < nx || G < nu) G *= 2;
  return launch(a, G, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
