// Fused ADMM kernels for Hopper (sm_90a): the whole batched solve, or a whole
// receding-horizon mission, in one launch. Three kernels share the iteration
// body in admm_iteration.cuh (see the design note there):
//
//   fused_solve_fixed_kernel     replaces accelerated_tinympc_tpu/ops/
//                                fused_admm.py _kernel_fixed
//   fused_solve_adaptive_kernel  replaces fused_admm.py _kernel_adaptive
//   fused_rollout_kernel         replaces ops/fused_rollout.py
//                                _kernel_rollout
//
// All three are bound by operations (FP32 FMA), not bytes: global memory is
// read once and written once per solve; the rollout writes one u0/iteration
// trace row per tick and keeps the (x0, D, Z, V) carry in shared memory
// across ticks (the TPU kernel's sequential tick grid dimension becomes a
// loop inside the block).
//
// Plain C interface (loaded with ctypes). Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or -1 when the caller's launch geometry does not match
// the kernel's own shared-memory layout).

#include "admm_iteration.cuh"

namespace atm {

extern __shared__ float4 smem4[];

template <bool ADAPTIVE>
__device__ inline void solve_block(const Args& a) {
  float* base = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(a.d);
  const Smem s = carve(base, L);
  const int b0 = blockIdx.x * a.d.tile;
  const int nb = min(a.d.tile, a.B - b0);

  stage_block(a, L, base, s);
  for (int c = threadIdx.x; c < a.d.Du; c += blockDim.x) s.cd[c] = a.cd[c];
  load_carry(a, s, b0, nb, /*with_duals=*/true);
  reset_solve(a, s, nb);
  __syncthreads();
  compute_xbub(a, s, s.x0, nb);
  __syncthreads();
  solve_core<ADAPTIVE>(a, s, b0, a.U, a.X, /*keep_u0=*/false);
  write_result(a, s, b0, nb);
}

__global__ void __launch_bounds__(256, 1) fused_solve_fixed_kernel(Args a) {
  solve_block<false>(a);
}

__global__ void __launch_bounds__(256, 1) fused_solve_adaptive_kernel(Args a) {
  solve_block<true>(a);
}

// Whole mission: per tick dual reset, solve (fixed or adaptive, warm-started
// D and slacks), trace of the pre-projection u0 and the iteration count,
// plant step x+ = A x + B u0. The final tick's full result is returned.
__global__ void __launch_bounds__(256, 1) fused_rollout_kernel(Args a) {
  float* base = reinterpret_cast<float*>(smem4);
  const Dims& d = a.d;
  const Layout L = make_layout(d);
  const Smem s = carve(base, L);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * d.tile;
  const int nb = min(d.tile, a.B - b0);

  stage_block(a, L, base, s);
  load_carry(a, s, b0, nb, /*with_duals=*/false);
  float* xc = s.x0;                  // current plant state
  float* xn = s.x0 + d.tile * d.nx;  // next plant state
  __syncthreads();

  for (int t = 0; t < a.ticks; ++t) {
    const bool last = t == a.ticks - 1;
    // Dual reset (reference: quadrotor_hovering.cpp:100-101) and the tick's
    // reference constant (tracking streams one const_d row per tick).
    for (int i = tid; i < d.tile * d.DzP; i += nt) s.YG[i] = 0.0f;
    const float* cd = a.tracking ? a.cd + (size_t)t * d.Du : a.cd;
    for (int c = tid; c < d.Du; c += nt) s.cd[c] = cd[c];
    reset_solve(a, s, nb);
    compute_xbub(a, s, xc, nb);
    __syncthreads();
    float* Uo = last ? a.U : nullptr;
    float* Xo = last ? a.X : nullptr;
    if (a.check_every > 0) solve_core<true>(a, s, b0, Uo, Xo, true);
    else solve_core<false>(a, s, b0, Uo, Xo, true);

    // Trace: pre-projection first-knot control and iteration count.
    for (int it = tid; it < nb * d.nu; it += nt) {
      const int i = it / d.nu, c = it - i * d.nu;
      a.us[((size_t)t * a.B + b0 + i) * d.nu + c] = s.u0[it];
    }
    for (int i = tid; i < nb; i += nt)
      a.iters[(size_t)t * a.B + b0 + i] = (int)s.stat[i * 6 + 0];
    // Plant step (reference: quadrotor_hovering.cpp:110).
    for (int it = tid; it < nb * d.nx; it += nt) {
      const int i = it / d.nx, r = it - i * d.nx;
      float ax = 0.0f, bu = 0.0f;
      for (int k = 0; k < d.nx; ++k)
        ax = fmaf(xc[i * d.nx + k], s.A[r * d.nx + k], ax);
      for (int k = 0; k < d.nu; ++k)
        bu = fmaf(s.u0[i * d.nu + k], s.Bm[r * d.nu + k], bu);
      xn[it] = ax + bu;
    }
    float* tmp = xc; xc = xn; xn = tmp;
    __syncthreads();
  }

  for (int it = tid; it < nb * d.nx; it += nt)
    a.x_final[(size_t)b0 * d.nx + it] = xc[it];
  write_result(a, s, b0, nb);
}

template <typename K>
static int launch(K kernel, Args a, int threads, int smem_bytes,
                  cudaStream_t stream) {
  const Layout L = make_layout(a.d);
  if (smem_bytes != L.total * 4 || a.d.tile <= 0 || a.d.tile % RI != 0 ||
      threads < a.d.tile || threads % 32 != 0 || threads > 256 || a.B <= 0 ||
      a.max_iter < 1)
    return -1;
  // Split the backward product's depth over as many adjacent lanes (at most
  // 8) as it takes to give every thread of the block a tile.
  const int btiles = (a.d.DuP / TJ) * (a.d.tile / RI);
  int H = 1;
  while (H < 8 && btiles * H * 2 <= threads && H * 2 <= (a.d.DzP >> 2)) H *= 2;
  a.d.ksplit = H;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + a.d.tile - 1) / a.d.tile;
  kernel<<<blocks, threads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace atm

extern "C" {

// Bytes of dynamic shared memory one block needs (the layout's own count).
int atm_fused_smem_bytes(int nx, int nu, int N, int tile) {
  return atm::make_layout(atm::make_dims(nx, nu, N, tile)).total * 4;
}

// One batched solve. check_every == 0: fixed max_iter iterations; > 0: the
// adaptive kernel with a check every check_every iterations after warmup.
int atm_fused_solve(
    const float* x0, const float* D0, const float* Y0, const float* G0,
    const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    int B, int nx, int nu, int N, int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, void* stream) {
  atm::Args a = {};
  a.x0 = x0; a.D0 = D0; a.Y0 = Y0; a.G0 = G0; a.Z0 = Z0; a.V0 = V0;
  a.Wf = Wf; a.Wb = Wb; a.Wx = Wx; a.cd = cd; a.lo = lo; a.hi = hi;
  a.A = nullptr; a.Bm = nullptr;
  a.U = U; a.X = X; a.D = D; a.Y = Y; a.G = G; a.Z = Z; a.V = V;
  a.stats = stats;
  a.B = B; a.ticks = 1; a.tracking = 0;
  a.max_iter = max_iter; a.check_every = check_every; a.warmup = warmup;
  a.rho = rho; a.alpha = alpha; a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  a.d = atm::make_dims(nx, nu, N, tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (check_every > 0)
    return atm::launch(atm::fused_solve_adaptive_kernel, a, threads,
                       smem_bytes, st);
  return atm::launch(atm::fused_solve_fixed_kernel, a, threads, smem_bytes,
                     st);
}

// One mission of `ticks` receding-horizon ticks. tracking != 0: cd is
// (ticks, Du), one row per tick; else (Du).
int atm_fused_rollout(
    const float* x0, const float* D0, const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi, const float* A, const float* Bm,
    float* us, int* iters, float* x_final,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    int B, int nx, int nu, int N, int ticks, int tracking,
    int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, void* stream) {
  if (ticks < 1) return -1;
  atm::Args a = {};
  a.x0 = x0; a.D0 = D0; a.Y0 = nullptr; a.G0 = nullptr; a.Z0 = Z0; a.V0 = V0;
  a.Wf = Wf; a.Wb = Wb; a.Wx = Wx; a.cd = cd; a.lo = lo; a.hi = hi;
  a.A = A; a.Bm = Bm;
  a.U = U; a.X = X; a.D = D; a.Y = Y; a.G = G; a.Z = Z; a.V = V;
  a.stats = stats;
  a.us = us; a.iters = iters; a.x_final = x_final;
  a.B = B; a.ticks = ticks; a.tracking = tracking;
  a.max_iter = max_iter; a.check_every = check_every; a.warmup = warmup;
  a.rho = rho; a.alpha = alpha; a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  a.d = atm::make_dims(nx, nu, N, tile);
  return atm::launch(atm::fused_rollout_kernel, a, threads, smem_bytes,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
