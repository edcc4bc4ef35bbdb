// Fused ADMM kernels for Hopper (sm_90a): the whole batched solve, or a whole
// receding-horizon mission, in one launch. The kernels share the iteration
// body in admm_iteration.cuh (see the design note there: persistent blocks
// of per-instance slots fed by a work counter, FP32 FMA products from
// register tiles):
//
//   fused_solve_fixed_kernel     replaces accelerated_tinympc_tpu/ops/
//                                fused_admm.py _kernel_fixed
//   fused_solve_adaptive_kernel  replaces fused_admm.py _kernel_adaptive
//   fused_rollout_kernel         replaces ops/fused_rollout.py
//                                _kernel_rollout (adaptive tick solves;
//                                fused_rollout_fixed_kernel the fixed ones)
//
// Each has a second instantiation with second-order cones in the slack stage
// (template parameter CONES; replaces fused_admm.py _cone_apply, which the
// TPU kernels close over when cone operands are given). The box-only
// instantiations contain no cone code. Every kernel is a template over the
// operators' placement (GOPS: staged in shared memory, or read from device
// memory where they do not fit beside one register tile of slots); both
// placements of a kernel share its name and its launch counter. A third
// instantiation, with the operators in device memory and register tiles of
// 4 slots (RI = 4), takes the horizons where one tile of 8 slots' state does
// not fit shared memory; it counts under the same name too.
//
// All are bound by operations (FP32 FMA), not bytes: global memory is read
// once and written once per solve; the rollout writes one u0/iteration trace
// row per tick and keeps the (x0, D, Z, V) carry of an instance in its slot
// across ticks (the TPU kernel's sequential tick grid dimension becomes a
// per-slot tick counter).
//
// Plain C interface (loaded with ctypes). Every entry launches on the given
// stream, does not synchronise, allocates nothing (the work counter is the
// caller's, zeroed before the launch), and returns cudaGetLastError() (or -1
// when the caller's launch geometry does not match the kernel's own
// shared-memory layout).

#include "admm_iteration.cuh"

namespace atm {

extern __shared__ float4 smem4[];

#define ATM_KERNEL(name, ADAPTIVE, CONES, ROLLOUT)                  \
  template <bool GOPS, int RI>                                      \
  __global__ void __launch_bounds__(256, 1) name(Args a) {          \
    run_block<RI, ADAPTIVE, CONES, ROLLOUT, GOPS>(                  \
        a, reinterpret_cast<float*>(smem4));                        \
  }

ATM_KERNEL(fused_solve_fixed_kernel, false, false, false)
ATM_KERNEL(fused_solve_adaptive_kernel, true, false, false)
ATM_KERNEL(fused_solve_fixed_cones_kernel, false, true, false)
ATM_KERNEL(fused_solve_adaptive_cones_kernel, true, true, false)
// Whole mission: per tick and slot, dual reset, solve (fixed or adaptive,
// warm-started D and slacks), trace of the pre-projection u0 and the
// iteration count, plant step x+ = A x + B u0. The final tick's full result
// is returned. The adaptive and fixed tick solves are two instantiations.
ATM_KERNEL(fused_rollout_kernel, true, false, true)
ATM_KERNEL(fused_rollout_fixed_kernel, false, false, true)
ATM_KERNEL(fused_rollout_cones_kernel, true, true, true)
ATM_KERNEL(fused_rollout_fixed_cones_kernel, false, true, true)

#undef ATM_KERNEL

// The cone table: device arrays cone_idx (per cone the offset of its row,
// then the rows [nball, axis, ball[nball]]) and cone_par ([mu, shift] per
// cone), built and validated by the wrapper (ops/fused_admm.py pad_cones).
// Returns false if a count or a pointer is missing.
static bool fill_cones(Args& a, const int* cone_idx, const float* cone_par,
                       int nc_u, int nc_x, const float* cone_mu,
                       const float* cone_shift) {
  if (nc_u < 0 || nc_x < 0 || nc_u + nc_x < 1 || cone_par == nullptr)
    return false;
  if ((cone_mu == nullptr) != (cone_shift == nullptr)) return false;
  a.cones = {nc_u, nc_x, cone_idx, cone_par};
  a.cone_mu = cone_mu;
  a.cone_shift = cone_shift;
  return true;
}

// The kernel of the operators' placement (GOPS when they are read from
// device memory) and register tile: 8 slots, or 4 with GOPS only.
template <typename K>
static int launch(K kernel_smem, K kernel_gops, K kernel_gops4, Args a,
                  int threads, int smem_bytes, cudaStream_t stream) {
  if (a.d.ri != 8 && !(a.d.ri == 4 && a.d.gops)) return -1;
  const K kernel = a.d.ri == 4 ? kernel_gops4
                               : (a.d.gops ? kernel_gops : kernel_smem);
  const int RI = a.d.ri;
  const Layout L = make_layout(a.d);
  if (smem_bytes != L.total * 4 || a.d.tile <= 0 || a.d.tile % RI != 0 ||
      threads < a.d.tile || threads % 32 != 0 || threads > 256 || a.B <= 0 ||
      a.max_iter < 1 || a.counter == nullptr)
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
  // Persistent blocks: as many as the SMs hold at once, and no more than
  // the batch fills.
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  const int need = (a.B + a.d.tile - 1) / a.d.tile;
  const int blocks = n_sm * per_sm < need ? n_sm * per_sm : need;
  kernel<<<blocks, threads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace atm

// The instantiations of one kernel, launched with the caller's geometry.
#define ATM_LAUNCH(k)                                                  \
  atm::launch(atm::k<false, 8>, atm::k<true, 8>, atm::k<true, 4>, a,   \
              threads, smem_bytes, st)

extern "C" {

// Bytes of dynamic shared memory one block needs (the layout's own count).
// ncp: cones with per-instance mu/shift rows (0 when the values are static).
// ops_global: the operators are read from device memory (not staged).
int atm_fused_smem_bytes(int nx, int nu, int N, int tile, int ncp,
                         int ops_global) {
  return atm::make_layout(
      atm::make_dims(nx, nu, N, tile, ncp, ops_global != 0)).total * 4;
}


// One batched solve. check_every == 0: fixed max_iter iterations; > 0: the
// adaptive kernel with a check every check_every iterations after warmup.
// cone_idx != nullptr selects the coned instantiation: cone_idx and cone_par
// are the device table (see fill_cones) of nc_u input and nc_x state cones,
// cone_mu / cone_shift device arrays (nc, B) of per-instance values, or both
// nullptr for the static ones. Wf, Wb and Wx come padded with zeros (DuP x
// DzP, DzP x DuP, nx x DzP); ops_global != 0: the kernel reads them in place
// in device memory, else it stages them per block in shared memory. ri: slots
// per register tile (8; 4 only with ops_global).
int atm_fused_solve(
    const float* x0, const float* D0, const float* Y0, const float* G0,
    const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    const int* cone_idx, const float* cone_par, int nc_u, int nc_x,
    const float* cone_mu, const float* cone_shift, int* counter,
    int B, int nx, int nu, int N, int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, int ops_global, int ri,
    void* stream) {
  atm::Args a = {};
  a.x0 = x0; a.D0 = D0; a.Y0 = Y0; a.G0 = G0; a.Z0 = Z0; a.V0 = V0;
  a.Wf = Wf; a.Wb = Wb; a.Wx = Wx; a.cd = cd; a.lo = lo; a.hi = hi;
  a.A = nullptr; a.Bm = nullptr;
  a.U = U; a.X = X; a.D = D; a.Y = Y; a.G = G; a.Z = Z; a.V = V;
  a.stats = stats;
  a.counter = counter;
  a.B = B; a.ticks = 1; a.tracking = 0;
  a.max_iter = max_iter; a.check_every = check_every; a.warmup = warmup;
  a.rho = rho; a.alpha = alpha; a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cone_idx != nullptr) {
    a.d = atm::make_dims(nx, nu, N, tile,
                         cone_mu != nullptr ? nc_u + nc_x : 0, ops_global, ri);
    if (!atm::fill_cones(a, cone_idx, cone_par, nc_u, nc_x, cone_mu,
                         cone_shift))
      return -1;
    if (check_every > 0)
      return ATM_LAUNCH(fused_solve_adaptive_cones_kernel);
    return ATM_LAUNCH(fused_solve_fixed_cones_kernel);
  }
  a.d = atm::make_dims(nx, nu, N, tile, 0, ops_global, ri);
  if (check_every > 0)
    return ATM_LAUNCH(fused_solve_adaptive_kernel);
  return ATM_LAUNCH(fused_solve_fixed_kernel);
}

// One mission of `ticks` receding-horizon ticks. tracking != 0: cd is
// (ticks, Du), one row per tick; else (Du). cone_idx / cone_par / nc_u /
// nc_x, ops_global and ri as in atm_fused_solve (static cone parameters
// only).
int atm_fused_rollout(
    const float* x0, const float* D0, const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi, const float* A, const float* Bm,
    float* us, int* iters, float* x_final,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    const int* cone_idx, const float* cone_par, int nc_u, int nc_x,
    int* counter,
    int B, int nx, int nu, int N, int ticks, int tracking,
    int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, int ops_global, int ri,
    void* stream) {
  if (ticks < 1) return -1;
  atm::Args a = {};
  a.x0 = x0; a.D0 = D0; a.Y0 = nullptr; a.G0 = nullptr; a.Z0 = Z0; a.V0 = V0;
  a.Wf = Wf; a.Wb = Wb; a.Wx = Wx; a.cd = cd; a.lo = lo; a.hi = hi;
  a.A = A; a.Bm = Bm;
  a.U = U; a.X = X; a.D = D; a.Y = Y; a.G = G; a.Z = Z; a.V = V;
  a.stats = stats;
  a.us = us; a.iters = iters; a.x_final = x_final;
  a.counter = counter;
  a.B = B; a.ticks = ticks; a.tracking = tracking;
  a.max_iter = max_iter; a.check_every = check_every; a.warmup = warmup;
  a.rho = rho; a.alpha = alpha; a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  a.d = atm::make_dims(nx, nu, N, tile, 0, ops_global, ri);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool adaptive = check_every > 0;
  if (cone_idx != nullptr) {
    if (!atm::fill_cones(a, cone_idx, cone_par, nc_u, nc_x, nullptr,
                         nullptr))
      return -1;
    return adaptive
        ? ATM_LAUNCH(fused_rollout_cones_kernel)
        : ATM_LAUNCH(fused_rollout_fixed_cones_kernel);
  }
  return adaptive
      ? ATM_LAUNCH(fused_rollout_kernel)
      : ATM_LAUNCH(fused_rollout_fixed_kernel);
}

}  // extern "C"

#undef ATM_LAUNCH
