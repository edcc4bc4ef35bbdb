// Batched infinite-horizon Riccati precompute for Hopper (sm_90a), one
// distinct plant per instance, FP32.
//
//   riccati_fixed_point_kernel  replaces accelerated_tinympc_tpu/ops/
//                               riccati_kernel.py _kernel (fixed point from
//                               P0 = rho I or a warm P0, K0)
//   riccati_newton_kernel       replaces riccati_kernel.py _kernel_newton
//                               (Newton-Kleinman from a stabilising K0)
//
// Design. One instance is ~900 floats of matrices at nx=12, nu=4 (A, P, K,
// B and the temporaries of one step): too many for one thread's registers,
// small for shared memory. So one warp owns one instance: its matrices live
// in the warp's slice of dynamic shared memory, row-major and unpadded, and
// every small product C = A B is spread over the lanes by output entry (lane
// e computes C[e / m][e % m] as a chain of FMAs over the depth). Inputs and
// outputs are plain (B, .) row-major arrays; there is no lane packing and no
// padding of the batch: a warp whose instance index is past the batch exits.
//
// The nu x nu system R1 + B'PB is symmetrised and factored by an unrolled
// Cholesky on lane 0 (it is tiny and sequential); the triangular solves run
// one right-hand-side column per lane.
//
// Convergence is per instance: the warp reduces max|Knew - K| with shuffles
// and leaves the loop at the first step below the tolerance, so the K and P
// it returns are that step's iterate, not a further one (the reference's
// stopping rule, src/tinympc/codegen.cpp:273-285). A non-finite step also
// ends the loop (its delta fails `delta >= tol`) and the non-finite values are
// returned as they are: the Newton kernel reports a K0 that does not
// stabilise its plant this way.
//
// What bounds it: operations. One fixed-point step is 2(2 nu nx^2 + nu^2 nx +
// nu nx^2 + 2 nx^3) FLOP per instance on ~6 KB that stay on the SM; global
// memory is read once and written once per instance.
//
// Plain C interface (loaded with ctypes): entries launch on the given stream,
// do not synchronise, allocate nothing and return cudaGetLastError(), or -1
// for sizes out of range.

#include <cuda_runtime.h>

namespace atm {

constexpr int RIC_MAX_NX = 16;
constexpr int RIC_MAX_NU = 8;
constexpr int WARPS_PER_BLOCK = 4;

struct RicArgs {
  const float *A, *B, *Q, *R, *rho;  // (Bn,nx,nx) (Bn,nx,nu) (Bn,nx) (Bn,nu) (Bn)
  const float *P0, *K0;              // warm start (Bn,nx,nx), (Bn,nu,nx) or null
  float *Kinf, *Pinf, *Quu_inv, *AmBKt, *coeff;
  int* iters;                        // (Bn)
  int Bn, nx, nu;
  int max_iters, inner_iters;
  float tol;
};

// Floats of shared memory one warp needs.
__host__ __device__ inline int warp_floats(int nx, int nu) {
  const int xx = nx * nx, ux = nu * nx, uu = nu * nu;
  // A, P, T1, T2, T3 (nx x nx); B, K, Kn, BtP, N1 (nu x nx or nx x nu);
  // M, L (nu x nu); Qa, Ra
  return 5 * xx + 5 * ux + 2 * uu + nx + nu;
}

struct Mats {
  float *A, *P, *T1, *T2, *T3, *B, *K, *Kn, *BtP, *N1, *M, *L, *Qa, *Ra;
};

__device__ inline Mats carve(float* w, int nx, int nu) {
  const int xx = nx * nx, ux = nu * nx, uu = nu * nu;
  Mats m;
  m.A = w; w += xx; m.P = w; w += xx; m.T1 = w; w += xx; m.T2 = w; w += xx;
  m.T3 = w; w += xx;
  m.B = w; w += ux; m.K = w; w += ux; m.Kn = w; w += ux; m.BtP = w; w += ux;
  m.N1 = w; w += ux;
  m.M = w; w += uu; m.L = w; w += uu;
  m.Qa = w; w += nx; m.Ra = w;
  return m;
}

// C (n x m) = op(A) (n x k) * B (k x m), entries spread over the lanes.
// TA: A is stored (k x n) and used transposed.
template <bool TA>
__device__ inline void mm(float* C, const float* A, const float* B, int n,
                          int k, int m, int lane) {
  for (int e = lane; e < n * m; e += 32) {
    const int i = e / m, j = e - i * m;
    float acc = 0.0f;
    for (int t = 0; t < k; ++t)
      acc = fmaf(TA ? A[t * n + i] : A[i * k + t], B[t * m + j], acc);
    C[e] = acc;
  }
  __syncwarp();
}

// M (n x n) <- 0.5 (M + M') + diag(dg), in place.
__device__ inline void sym_add_diag(float* M, const float* dg, int n,
                                    int lane) {
  float keep[(RIC_MAX_NX * RIC_MAX_NX + 31) / 32];
  int q = 0;
  for (int e = lane; e < n * n; e += 32, ++q) {
    const int i = e / n, j = e - i * n;
    const float half = 0.5f * (M[i * n + j] + M[j * n + i]);
    keep[q] = i == j && dg != nullptr ? half + dg[i] : half;
  }
  __syncwarp();
  q = 0;
  for (int e = lane; e < n * n; e += 32, ++q) M[e] = keep[q];
  __syncwarp();
}

// Lower Cholesky factor of the SPD n x n matrix M into L, on lane 0.
__device__ inline void chol(float* L, const float* M, int n, int lane) {
  if (lane == 0) {
    for (int j = 0; j < n; ++j) {
      float sj = M[j * n + j];
      for (int t = 0; t < j; ++t) sj -= L[j * n + t] * L[j * n + t];
      const float ljj = sqrtf(sj);
      L[j * n + j] = ljj;
      const float inv = 1.0f / ljj;
      for (int i = j + 1; i < n; ++i) {
        float sv = M[i * n + j];
        for (int t = 0; t < j; ++t) sv -= L[i * n + t] * L[j * n + t];
        L[i * n + j] = sv * inv;
      }
    }
  }
  __syncwarp();
}

// Solve (L L') X = N for X (n x m), one column per lane, in place in N.
__device__ inline void chol_solve(const float* L, float* N, int n, int m,
                                  int lane) {
  for (int j = lane; j < m; j += 32) {
    for (int i = 0; i < n; ++i) {
      float sv = N[i * m + j];
      for (int t = 0; t < i; ++t) sv -= L[i * n + t] * N[t * m + j];
      N[i * m + j] = sv / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float sv = N[i * m + j];
      for (int t = i + 1; t < n; ++t) sv -= L[t * n + i] * N[t * m + j];
      N[i * m + j] = sv / L[i * n + i];
    }
  }
  __syncwarp();
}

// Kn = (R1 + B'PB)^-1 B'PA, the reference's gain update; leaves the factor
// of the symmetrised system in m.L.
__device__ inline void kgain(const Mats& m, int nx, int nu, int lane) {
  mm<true>(m.BtP, m.B, m.P, nu, nx, nx, lane);    // B'P   (nu x nx)
  mm<false>(m.M, m.BtP, m.B, nu, nx, nu, lane);   // B'PB  (nu x nu)
  sym_add_diag(m.M, m.Ra, nu, lane);
  chol(m.L, m.M, nu, lane);
  mm<false>(m.Kn, m.BtP, m.A, nu, nx, nx, lane);  // B'PA  (nu x nx)
  chol_solve(m.L, m.Kn, nu, nx, lane);
}

// max |Kn - K| over the warp.
__device__ inline float delta_k(const Mats& m, int nx, int nu, int lane) {
  float d = 0.0f;
  bool bad = false;
  for (int e = lane; e < nu * nx; e += 32) {
    const float v = fabsf(m.Kn[e] - m.K[e]);
    bad |= !(v == v);
    d = fmaxf(d, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    d = fmaxf(d, __shfl_xor_sync(0xffffffffu, d, off));
  // fmaxf drops a NaN: carry it separately so a non-finite step ends the loop.
  if (__any_sync(0xffffffffu, bad)) d = __int_as_float(0x7fc00000);
  return d;
}

__device__ inline void copy(float* dst, const float* src, int n, int lane) {
  for (int e = lane; e < n; e += 32) dst[e] = src[e];
  __syncwarp();
}

// Load one instance's plant and rho-augmented cost diagonals.
__device__ inline void load_plant(const RicArgs& a, const Mats& m, int b,
                                  int lane) {
  const int nx = a.nx, nu = a.nu;
  const float rho = a.rho[b];
  for (int e = lane; e < nx * nx; e += 32) m.A[e] = a.A[(size_t)b * nx * nx + e];
  for (int e = lane; e < nx * nu; e += 32) m.B[e] = a.B[(size_t)b * nx * nu + e];
  for (int e = lane; e < nx; e += 32) m.Qa[e] = a.Q[(size_t)b * nx + e] + rho;
  for (int e = lane; e < nu; e += 32) m.Ra[e] = a.R[(size_t)b * nu + e] + rho;
  __syncwarp();
}

// Quu_inv, AmBKt, coeff_d2p from the frozen K, P (reference
// codegen.cpp:287-292) and the write of all six outputs.
__device__ inline void emit_cache(const RicArgs& a, const Mats& m, int b,
                                  int iters, int lane) {
  const int nx = a.nx, nu = a.nu;
  mm<true>(m.BtP, m.B, m.P, nu, nx, nx, lane);
  mm<false>(m.M, m.BtP, m.B, nu, nx, nu, lane);
  sym_add_diag(m.M, m.Ra, nu, lane);
  chol(m.L, m.M, nu, lane);
  for (int e = lane; e < nu * nu; e += 32) m.M[e] = (e / nu == e % nu) ? 1.0f : 0.0f;
  __syncwarp();
  chol_solve(m.L, m.M, nu, nu, lane);             // M <- Quu_inv
  mm<false>(m.T1, m.B, m.K, nx, nu, nx, lane);    // BK
  for (int e = lane; e < nx * nx; e += 32) {
    const int i = e / nx, j = e - i * nx;
    m.T2[j * nx + i] = m.A[e] - m.T1[e];          // AmBKt
  }
  __syncwarp();
  mm<false>(m.N1, m.P, m.B, nx, nx, nu, lane);    // PB      (nx x nu)
  mm<false>(m.BtP, m.T2, m.N1, nx, nx, nu, lane); // AmBKt PB (nx x nu)
  for (int e = lane; e < nx * nu; e += 32) {
    const int i = e / nu, j = e - i * nu;
    a.coeff[(size_t)b * nx * nu + e] = m.K[j * nx + i] * m.Ra[j] - m.BtP[e];
  }
  for (int e = lane; e < nu * nx; e += 32) a.Kinf[(size_t)b * nu * nx + e] = m.K[e];
  for (int e = lane; e < nx * nx; e += 32) {
    a.Pinf[(size_t)b * nx * nx + e] = m.P[e];
    a.AmBKt[(size_t)b * nx * nx + e] = m.T2[e];
  }
  for (int e = lane; e < nu * nu; e += 32) a.Quu_inv[(size_t)b * nu * nu + e] = m.M[e];
  if (lane == 0) a.iters[b] = iters;
}

extern __shared__ float ric_smem[];

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
riccati_fixed_point_kernel(RicArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (b >= a.Bn) return;  // whole warps only: no block-wide barrier below
  const int nx = a.nx, nu = a.nu;
  const Mats m = carve(ric_smem + warp * warp_floats(nx, nu), nx, nu);
  load_plant(a, m, b, lane);
  if (a.P0 != nullptr) {
    for (int e = lane; e < nx * nx; e += 32) m.P[e] = a.P0[(size_t)b * nx * nx + e];
    for (int e = lane; e < nu * nx; e += 32) m.K[e] = a.K0[(size_t)b * nu * nx + e];
  } else {
    const float rho = a.rho[b];
    for (int e = lane; e < nx * nx; e += 32) m.P[e] = (e / nx == e % nx) ? rho : 0.0f;
    for (int e = lane; e < nu * nx; e += 32) m.K[e] = 0.0f;
  }
  __syncwarp();

  int it = 0;
  while (it < a.max_iters) {
    kgain(m, nx, nu, lane);                          // Kn
    mm<false>(m.T1, m.B, m.Kn, nx, nu, nx, lane);    // B Kn
    for (int e = lane; e < nx * nx; e += 32) m.T1[e] = m.A[e] - m.T1[e];
    __syncwarp();
    mm<false>(m.T2, m.P, m.T1, nx, nx, nx, lane);    // P (A - B Kn)
    mm<true>(m.T3, m.A, m.T2, nx, nx, nx, lane);     // A' P (A - B Kn)
    sym_add_diag(m.T3, m.Qa, nx, lane);
    const float delta = delta_k(m, nx, nu, lane);
    copy(m.K, m.Kn, nu * nx, lane);
    copy(m.P, m.T3, nx * nx, lane);
    ++it;
    if (!(delta >= a.tol)) break;  // converged, or a non-finite step
  }
  emit_cache(a, m, b, it, lane);
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
riccati_newton_kernel(RicArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (b >= a.Bn) return;
  const int nx = a.nx, nu = a.nu;
  const Mats m = carve(ric_smem + warp * warp_floats(nx, nu), nx, nu);
  load_plant(a, m, b, lane);
  for (int e = lane; e < nu * nx; e += 32) m.K[e] = a.K0[(size_t)b * nu * nx + e];
  for (int e = lane; e < nx * nx; e += 32) m.P[e] = 0.0f;
  __syncwarp();

  int it = 0;
  while (it < a.max_iters) {
    // W = Q1 + K' R1 K into P (the Stein sum S), Mj = A - B K into T1.
    for (int e = lane; e < nu * nx; e += 32) m.N1[e] = m.Ra[e / nx] * m.K[e];
    __syncwarp();
    mm<true>(m.P, m.K, m.N1, nx, nu, nx, lane);
    sym_add_diag(m.P, m.Qa, nx, lane);
    mm<false>(m.T1, m.B, m.K, nx, nu, nx, lane);
    for (int e = lane; e < nx * nx; e += 32) m.T1[e] = m.A[e] - m.T1[e];
    __syncwarp();
    // Doubling: S += Mj' S Mj; Mj = Mj Mj.
    for (int j = 0; j < a.inner_iters; ++j) {
      mm<false>(m.T2, m.P, m.T1, nx, nx, nx, lane);   // S Mj
      mm<true>(m.T3, m.T1, m.T2, nx, nx, nx, lane);   // Mj' S Mj
      for (int e = lane; e < nx * nx; e += 32) m.P[e] += m.T3[e];
      __syncwarp();
      mm<false>(m.T2, m.T1, m.T1, nx, nx, nx, lane);  // Mj Mj
      copy(m.T1, m.T2, nx * nx, lane);
    }
    sym_add_diag(m.P, nullptr, nx, lane);
    kgain(m, nx, nu, lane);
    const float delta = delta_k(m, nx, nu, lane);
    copy(m.K, m.Kn, nu * nx, lane);
    ++it;
    if (!(delta >= a.tol)) break;
  }
  emit_cache(a, m, b, it, lane);
}

template <typename K>
static int launch(K kernel, const RicArgs& a, cudaStream_t stream) {
  if (a.Bn <= 0 || a.nx < 1 || a.nx > RIC_MAX_NX || a.nu < 1 ||
      a.nu > RIC_MAX_NU || a.max_iters < 1)
    return -1;
  const int smem = WARPS_PER_BLOCK * warp_floats(a.nx, a.nu) * 4;
  const int blocks = (a.Bn + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  kernel<<<blocks, 32 * WARPS_PER_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace atm

extern "C" {

// Fixed point. P0 and K0 both null (cold: P0 = rho I, K0 = 0) or both given.
int atm_riccati_fixed_point(
    const float* A, const float* B, const float* Q, const float* R,
    const float* rho, const float* P0, const float* K0,
    float* Kinf, float* Pinf, float* Quu_inv, float* AmBKt, float* coeff,
    int* iters, int Bn, int nx, int nu, int max_iters, float tol,
    void* stream) {
  if ((P0 == nullptr) != (K0 == nullptr)) return -1;
  atm::RicArgs a = {A, B, Q, R, rho, P0, K0, Kinf, Pinf, Quu_inv, AmBKt,
                    coeff, iters, Bn, nx, nu, max_iters, 0, tol};
  return atm::launch(atm::riccati_fixed_point_kernel, a,
                     static_cast<cudaStream_t>(stream));
}

// Newton-Kleinman from the gain K0; max_outer outer steps of inner_iters
// doublings each.
int atm_riccati_newton(
    const float* A, const float* B, const float* Q, const float* R,
    const float* rho, const float* K0,
    float* Kinf, float* Pinf, float* Quu_inv, float* AmBKt, float* coeff,
    int* iters, int Bn, int nx, int nu, int max_outer, int inner_iters,
    float tol, void* stream) {
  if (K0 == nullptr || inner_iters < 0) return -1;
  atm::RicArgs a = {A, B, Q, R, rho, nullptr, K0, Kinf, Pinf, Quu_inv, AmBKt,
                    coeff, iters, Bn, nx, nu, max_outer, inner_iters, tol};
  return atm::launch(atm::riccati_newton_kernel, a,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
