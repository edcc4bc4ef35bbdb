// Heterogeneous-plant ADMM kernels for Hopper (sm_90a): a distinct plant and
// Riccati cache per instance, FP32.
//
//   hetero_kernel<G, false>  replaces accelerated_tinympc_tpu/ops/
//                            hetero_admm.py _kernel (fixed iterations; its
//                            _make_iteration, _dotb, _apply_cones and
//                            _project_soc_seg[_masked] helpers)
//   hetero_kernel<G, true>   replaces hetero_admm.py _kernel_adaptive
//                            (per-instance early exit, snapshot semantics)
//
// What bounds it: operations. One iteration is a pair of dependent
// recurrences of small matrix-vector products per instance, 2 m (2 nx nu +
// nx^2 + nu nx + nu^2 + nx^2 + nx nu) FLOP (m = N-1 knots; forward: Kinf, A,
// B; backward: B', Quu_inv, AmBKt, Kinf'), against ~7 KB per instance read
// and written once per solve. Every instance has its own matrices, so nothing
// is shared across a block and there is no tile for the tensor cores.
//
// Design. A group of G = pow2 >= max(nx, nu) lanes (4..32) owns one instance,
// 32 / G instances share a warp.
//  * Matrices in registers: lane i keeps row i of A, AmBKt, B and Kinf' (the
//    products whose output is a state), lane j < nu row j of Kinf, B' and
//    Quu_inv (outputs that are inputs). Arrays are G long and indexed only
//    with unrolled constants, so they stay in registers.
//  * Vectors by shuffle: a product y = M v has lane i accumulate M[i][k] v_k
//    with v_k broadcast from lane k of the group (__shfl_sync, width G).
//  * Iterates per knot in shared memory, each lane touching its own
//    component only: X, V (two buffers), G, qc, state bounds; U, Z (two
//    buffers), Y, D, input bounds; and mu/shift per cone. The forward
//    rollout is fused with the slack projection, cones and dual update knot
//    by knot; the backward pass rebuilds r and q from the post-update slacks
//    (reference admm.cpp:77-85 before :15-22).
//  * Cones: ball sums and the axis value are group reductions (xor shuffles
//    inside the group). Membership is a bit per cone per lane, from the
//    static indices or from the per-instance masks.
//  * Adaptive mode: the new slacks go to the other buffer; an instance that
//    converges at a check keeps the old slacks (pre-save Z, V), skips the
//    backward pass (pre-backward D) and keeps Y, G, U, X of that iteration.
//    Its group then stops writing; the warp runs until all its groups are
//    done. An instance's arithmetic does not depend on where it sits in the
//    batch, so a compacted re-launch continues it bit for bit.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError(), or -1 for sizes out of range.

#include <cuda_runtime.h>

#include "group_ops.cuh"

namespace atm_hetero {

using namespace atm_group;

constexpr int MAXC = 8;
constexpr int MAXDIM = 32;
constexpr int THREADS = 128;

struct Args {
  const float *x0, *A, *Bm, *K, *Quu, *M;
  const float *umin, *umax, *xmin, *xmax, *qc, *pterm, *rho;
  const float *d0, *y0, *g0, *z0, *v0;
  float *U, *X, *d, *y, *g, *z, *v, *stats;
  const float *cparams, *cmasks;  // (Bn, nc, 2), (Bn, MR) or null
  int Bn, nx, nu, N, max_iter, check_every, en_ib, en_sb;
  float pri_tol, dua_tol;
  int ipb;                        // instances per block
  int nc_u, nc_x;
  unsigned ball[MAXC];            // static ball indices as bits
  int axis[MAXC];
  float mu[MAXC], shift[MAXC];
};

// Shared-memory floats one instance needs.
__host__ __device__ inline int inst_floats(int nx, int nu, int N, int nc) {
  return 7 * N * nx + 7 * (N - 1) * nu + 2 * nc;
}

// One instance's registers and shared-memory slice.
template <int G>
struct Inst {
  float Ar[G], Mr[G], Br[G], Ktr[G];  // lane < nx: rows of A, AmBKt, B, Kinf'
  float Kr[G], Btr[G], Qr[G];         // lane < nu: rows of Kinf, B', Quu_inv
  float x0, pt, rho;
  unsigned bbits, abits;
  float *X, *V0, *V1, *Gd, *Qc, *XL, *XH;  // buffers 0/1 selected by ternaries
  float *U, *Z0, *Z1, *Y, *D, *UL, *UH, *CP;
};

// Forward rollout fused with the slack projection, cones and dual update,
// knot by knot; new slacks into buffer `wn`, old ones read from `ro`. With
// `res` the residual maxima of this iteration (reference admm.cpp:95-98,
// dual ones without rho) come back group-reduced. Stores only with `wr`.
template <int G>
__device__ inline void forward(const Args& a, Inst<G>& s, int lane, int ro,
                               int wn, bool res, bool wr, float r[4]) {
  const int nx = a.nx, nu = a.nu, m = a.N - 1;
  const bool lx = lane < nx, lu = lane < nu;
  const float* Vo = ro ? s.V1 : s.V0;
  const float* Zo = ro ? s.Z1 : s.Z0;
  float* Vn = wn ? s.V1 : s.V0;
  float* Zn = wn ? s.Z1 : s.Z0;
  float ps = 0.0f, ds = 0.0f, pu = 0.0f, du = 0.0f;
  float xi = s.x0;
  for (int i = 0; i <= m; ++i) {
    const int ex = i * nx + lane;
    const float tx = xi + (lx ? s.Gd[ex] : 0.0f);
    float vn = (a.en_sb && lx) ? clip(tx, s.XL[ex], s.XH[ex]) : tx;
    if (a.nc_x) vn = cones<G>(lx ? vn : 0.0f, a.nc_u, a.nc_x, s.bbits, s.abits,
                              s.CP);
    if (lx) {
      if (res) {
        ps = nanmax(ps, fabsf(xi - vn));
        ds = nanmax(ds, fabsf(Vo[ex] - vn));
      }
      if (wr) {
        s.X[ex] = xi;
        Vn[ex] = vn;
        s.Gd[ex] = tx - vn;
      }
    }
    if (i == m) break;
    const int eu = i * nu + lane;
    const float u = -dot<G>(s.Kr, xi) - (lu ? s.D[eu] : 0.0f);
    const float su = u + (lu ? s.Y[eu] : 0.0f);
    float zn = (a.en_ib && lu) ? clip(su, s.UL[eu], s.UH[eu]) : su;
    if (a.nc_u) zn = cones<G>(lu ? zn : 0.0f, 0, a.nc_u, s.bbits, s.abits,
                              s.CP);
    if (lu) {
      if (res) {
        pu = nanmax(pu, fabsf(u - zn));
        du = nanmax(du, fabsf(Zo[eu] - zn));
      }
      if (wr) {
        s.U[eu] = u;
        Zn[eu] = zn;
        s.Y[eu] = su - zn;
      }
    }
    xi = dot<G>(s.Ar, xi) + dot<G>(s.Br, u);
  }
  if (res) {
    r[0] = gmax<G>(ps);
    r[1] = gmax<G>(ds);
    r[2] = gmax<G>(pu);
    r[3] = gmax<G>(du);
  }
  __syncwarp();
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
  __syncwarp();
}

extern __shared__ float hetero_smem[];

template <int G, bool ADAPTIVE>
__global__ void __launch_bounds__(THREADS) hetero_kernel(Args a) {
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int b = blockIdx.x * a.ipb + grp;
  const bool valid = b < a.Bn;
  const size_t bl = valid ? b : 0;   // a group past the batch reads instance 0
  const int nx = a.nx, nu = a.nu, N = a.N, m = N - 1;
  const int nc = a.nc_u + a.nc_x;
  const int XN = N * nx, UM = m * nu;
  const bool lx = lane < nx, lu = lane < nu;

  Inst<G> s;
  float* base = hetero_smem + grp * inst_floats(nx, nu, N, nc);
  s.X = base; s.V0 = base + XN; s.V1 = base + 2 * XN;
  s.Gd = base + 3 * XN; s.Qc = base + 4 * XN; s.XL = base + 5 * XN;
  s.XH = base + 6 * XN;
  float* ub = base + 7 * XN;
  s.U = ub; s.Z0 = ub + UM; s.Z1 = ub + 2 * UM; s.Y = ub + 3 * UM;
  s.D = ub + 4 * UM; s.UL = ub + 5 * UM; s.UH = ub + 6 * UM;
  s.CP = ub + 7 * UM;

  // Per-knot operands and the carry into shared memory (coalesced: the
  // group's lanes stride over the instance's contiguous rows).
  for (int e = lane; e < XN; e += G) {
    const size_t o = bl * XN + e;
    s.X[e] = 0.0f;
    s.V0[e] = a.v0[o]; s.V1[e] = a.v0[o];
    s.Gd[e] = a.g0[o]; s.Qc[e] = a.qc[o];
    s.XL[e] = a.xmin[o]; s.XH[e] = a.xmax[o];
  }
  for (int e = lane; e < UM; e += G) {
    const size_t o = bl * UM + e;
    s.U[e] = 0.0f;
    s.Z0[e] = a.z0[o]; s.Z1[e] = a.z0[o];
    s.Y[e] = a.y0[o]; s.D[e] = a.d0[o];
    s.UL[e] = a.umin[o]; s.UH[e] = a.umax[o];
  }
  for (int c = lane; c < nc; c += G) {
    s.CP[2 * c] = a.cparams ? a.cparams[(bl * nc + c) * 2] : a.mu[c];
    s.CP[2 * c + 1] = a.cparams ? a.cparams[(bl * nc + c) * 2 + 1] : a.shift[c];
  }
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
  // Cone membership bits of this lane.
  s.bbits = 0u;
  s.abits = 0u;
  const int MR = 2 * nu * a.nc_u + 2 * nx * a.nc_x;
  for (int c = 0; c < nc; ++c) {
    const bool in_u = c < a.nc_u;
    const int dim = in_u ? nu : nx;
    if (lane >= dim) continue;
    bool inb, isax;
    if (a.cmasks) {
      const int off = in_u ? 2 * nu * c : 2 * nu * a.nc_u + 2 * nx * (c - a.nc_u);
      inb = a.cmasks[bl * MR + off + lane] != 0.0f;
      isax = a.cmasks[bl * MR + off + dim + lane] != 0.0f;
    } else {
      inb = (a.ball[c] >> lane) & 1u;
      isax = lane == a.axis[c];
    }
    if (inb) s.bbits |= 1u << c;
    if (isax) s.abits |= 1u << c;
  }
  __syncwarp();

  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = (float)a.max_iter, solved = 0.0f;
  int par = 0;
  if (!ADAPTIVE) {
    // Fixed: max_iter iterations, slacks in place; the last one's residuals
    // compare the final slacks with the penultimate ones.
    for (int it = 0; it < a.max_iter; ++it) {
      forward<G>(a, s, lane, 0, 0, it == a.max_iter - 1, valid, r);
      backward<G>(a, s, lane, 0, valid);
    }
    if (a.max_iter <= 0) {  // U = X = 0 against the carried slacks
      float ps = 0.0f, pu = 0.0f;
      for (int e = lane; e < XN; e += G) ps = nanmax(ps, fabsf(s.V0[e]));
      for (int e = lane; e < UM; e += G) pu = nanmax(pu, fabsf(s.Z0[e]));
      r[0] = gmax<G>(ps);
      r[2] = gmax<G>(pu);
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
      forward<G>(a, s, lane, par, par ^ 1, chk, live, rr);
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
  const size_t ox = bl * XN, ou = bl * UM;
  const float* Vf = par ? s.V1 : s.V0;
  const float* Zf = par ? s.Z1 : s.Z0;
  for (int e = lane; e < XN; e += G) {
    a.X[ox + e] = s.X[e];
    a.v[ox + e] = Vf[e];
    a.g[ox + e] = s.Gd[e];
  }
  for (int e = lane; e < UM; e += G) {
    a.U[ou + e] = s.U[e];
    a.z[ou + e] = Zf[e];
    a.y[ou + e] = s.Y[e];
    a.d[ou + e] = s.D[e];
  }
  if (lane == 0) {
    float* st = a.stats + bl * 8;
    st[0] = iters; st[1] = solved;
    st[2] = r[0]; st[3] = r[1]; st[4] = r[2]; st[5] = r[3];
    st[6] = 0.0f; st[7] = 0.0f;
  }
}

template <int G>
static int launch_g(const Args& a, int smem_bytes, cudaStream_t stream) {
  const int threads = a.ipb * G;
  const int blocks = (a.Bn + a.ipb - 1) / a.ipb;
  cudaError_t err;
  if (a.check_every > 0) {
    err = cudaFuncSetAttribute(hetero_kernel<G, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    hetero_kernel<G, true><<<blocks, threads, smem_bytes, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(hetero_kernel<G, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    hetero_kernel<G, false><<<blocks, threads, smem_bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace atm_hetero

extern "C" {

// One batched solve. check_every == 0: fixed max_iter iterations (K7); > 0:
// the adaptive kernel (K8). cone_idx == nullptr: no cones; otherwise host
// arrays cone_idx = [nc_u, nc_x, then per cone ball bit mask, axis] and
// cone_par = per cone [mu, shift]; cparams (Bn, nc, 2) and cmasks (Bn, MR)
// are device arrays of per-instance values or nullptr. ipb instances per
// block (ipb * G a multiple of 32, at most 128 threads) with smem_bytes of
// dynamic shared memory, which must equal ipb * inst_floats * 4.
int atm_hetero_solve(
    const float* x0, const float* A, const float* Bm, const float* K,
    const float* Quu, const float* M, const float* umin, const float* umax,
    const float* xmin, const float* xmax, const float* qc, const float* pterm,
    const float* rho, const float* d0, const float* y0, const float* g0,
    const float* z0, const float* v0,
    float* U, float* X, float* d, float* y, float* g, float* z, float* v,
    float* stats,
    const int* cone_idx, const float* cone_par, const float* cparams,
    const float* cmasks,
    int Bn, int nx, int nu, int N, int max_iter, int check_every, int en_ib,
    int en_sb, float pri_tol, float dua_tol, int ipb, int smem_bytes,
    void* stream) {
  using namespace atm_hetero;
  if (Bn <= 0 || nx < 1 || nx > MAXDIM || nu < 1 || nu > MAXDIM || N < 2 ||
      max_iter < 0 || check_every < 0 || (check_every > 0 && max_iter < 1) ||
      ipb < 1)
    return -1;
  Args a = {};
  a.x0 = x0; a.A = A; a.Bm = Bm; a.K = K; a.Quu = Quu; a.M = M;
  a.umin = umin; a.umax = umax; a.xmin = xmin; a.xmax = xmax;
  a.qc = qc; a.pterm = pterm; a.rho = rho;
  a.d0 = d0; a.y0 = y0; a.g0 = g0; a.z0 = z0; a.v0 = v0;
  a.U = U; a.X = X; a.d = d; a.y = y; a.g = g; a.z = z; a.v = v;
  a.stats = stats;
  a.cparams = cparams; a.cmasks = cmasks;
  a.Bn = Bn; a.nx = nx; a.nu = nu; a.N = N; a.max_iter = max_iter;
  a.check_every = check_every; a.en_ib = en_ib; a.en_sb = en_sb;
  a.pri_tol = pri_tol; a.dua_tol = dua_tol; a.ipb = ipb;
  if (cone_idx != nullptr) {
    a.nc_u = cone_idx[0];
    a.nc_x = cone_idx[1];
    const int nc = a.nc_u + a.nc_x;
    if (a.nc_u < 0 || a.nc_x < 0 || nc < 1 || nc > MAXC) return -1;
    for (int c = 0; c < nc; ++c) {
      const int dim = c < a.nc_u ? nu : nx;
      a.ball[c] = (unsigned)cone_idx[2 + 2 * c];
      a.axis[c] = cone_idx[3 + 2 * c];
      if (a.axis[c] < 0 || a.axis[c] >= dim) return -1;
      if (dim < 32 && (a.ball[c] >> dim) != 0u) return -1;
      a.mu[c] = cone_par[2 * c];
      a.shift[c] = cone_par[2 * c + 1];
    }
  } else if (cparams != nullptr || cmasks != nullptr) {
    return -1;
  }
  int G = 4;
  while (G < nx || G < nu) G *= 2;
  if ((ipb * G) % 32 != 0 || ipb * G > THREADS) return -1;
  if (smem_bytes != ipb * inst_floats(nx, nu, N, a.nc_u + a.nc_x) * 4)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 4: return launch_g<4>(a, smem_bytes, st);
    case 8: return launch_g<8>(a, smem_bytes, st);
    case 16: return launch_g<16>(a, smem_bytes, st);
    default: return launch_g<32>(a, smem_bytes, st);
  }
}

}  // extern "C"
