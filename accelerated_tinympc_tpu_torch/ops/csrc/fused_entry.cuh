// The fused kernels and their C entries, compiled twice: by fused_admm.cu
// with ATM_SPLIT 0 (float32 products) and by fused_admm_bf16x3.cu with
// ATM_SPLIT 1 (split-bf16 products on the tensor cores; the kernels' names
// end in _bf16x3). Both libraries export the same C entries; the Python
// wrapper loads the one of the mode asked for.

#pragma once
#include "admm_iteration.cuh"
#include "fixed_waves.cuh"

#ifndef ATM_SPLIT
#error "define ATM_SPLIT (0 or 1) before including fused_entry.cuh"
#endif
#if ATM_SPLIT
#define ATM_KNAME(name) name##_bf16x3_kernel
#else
#define ATM_KNAME(name) name##_kernel
#endif

namespace atm {
extern __shared__ float4 smem4[];

#define ATM_KERNEL(name, ADAPTIVE, CONES, ROLLOUT)                  \
  template <bool GOPS, int RI>                                      \
  __global__ void __launch_bounds__(256, 1) ATM_KNAME(name)(Args a) { \
    run_block<RI, ADAPTIVE, CONES, ROLLOUT, GOPS, (ATM_SPLIT != 0)>( \
        a, reinterpret_cast<float*>(smem4));                        \
  }

#if ATM_SPLIT
ATM_KERNEL(fused_solve_fixed, false, false, false)
#else
// K1: its own body (fixed_waves.cuh, WAVES) wherever wave_fits, else the
// shared slot body; every instantiation counts under the kernel's name.
// KDU, KDZ, KH: a shape launch_waves compiles with its widths and depth
// split known.
template <bool GOPS, int RI, bool WAVES = false, int KDU = 0, int KDZ = 0,
          int KH = 0>
__global__ void __launch_bounds__(256, 1) fused_solve_fixed_kernel(Args a) {
  if constexpr (WAVES)
    run_waves<GOPS, KDU, KDZ, KH>(a, reinterpret_cast<float*>(smem4));
  else
    run_block<RI, false, false, false, GOPS, false>(
        a, reinterpret_cast<float*>(smem4));
}
#endif
ATM_KERNEL(fused_solve_adaptive, true, false, false)
ATM_KERNEL(fused_solve_fixed_cones, false, true, false)
ATM_KERNEL(fused_solve_adaptive_cones, true, true, false)
// Whole mission: per tick and slot, dual reset, solve (fixed or adaptive,
// warm-started D and slacks), trace of the pre-projection u0 and the
// iteration count, plant step x+ = A x + B u0. The final tick's full result
// is returned. The adaptive and fixed tick solves are two instantiations.
ATM_KERNEL(fused_rollout, true, false, true)
ATM_KERNEL(fused_rollout_fixed, false, false, true)
ATM_KERNEL(fused_rollout_cones, true, true, true)
ATM_KERNEL(fused_rollout_fixed_cones, false, true, true)

#undef ATM_KERNEL


// The cone table: device arrays cone_idx (per cone the offset of its row,
// then the rows [nball, axis, ball[nball]]) and cone_par ([mu, shift] per
// cone), built and validated by the wrapper (ops/fused_admm.py pad_cones);
// cone_items: the fused cone pass's runs, cone_chunks of RUN_WORDS words
// (ops/fused_admm.py cone_items, for this launch's slots and register
// tile), or nullptr for the three coned passes. Returns false if a count
// or a pointer is missing, or if the items cannot cover the block's
// register tiles.
inline bool fill_cones(Args& a, const int* cone_idx, const float* cone_par,
                       int nc_u, int nc_x, const float* cone_mu,
                       const float* cone_shift, const int* cone_items,
                       int cone_chunks) {
  if (nc_u < 0 || nc_x < 0 || nc_u + nc_x < 1 || cone_par == nullptr)
    return false;
  if ((cone_mu == nullptr) != (cone_shift == nullptr)) return false;
  if (cone_items != nullptr &&
      (a.d.ri <= 0 || 32 * cone_chunks < (a.d.tile / a.d.ri) * (a.d.DzP / TJ)))
    return false;
  a.cones = {nc_u, nc_x, cone_idx, cone_par};
  a.cone_mu = cone_mu;
  a.cone_shift = cone_shift;
  a.cone_items = cone_items;
  a.cone_chunks = cone_items != nullptr ? cone_chunks : 0;
  return true;
}

// The backward product's depth split: over as many adjacent lanes (at most
// 8) as it takes to give every thread of the block a tile.
inline int ksplit_of(const Dims& d, int threads) {
  const int btiles = (d.DuP / TJ) * (d.tile / d.ri);
  int H = 1;
  while (H < 8 && btiles * H * 2 <= threads && H * 2 <= (d.DzP >> 2)) H *= 2;
  return H;
}

// Launches a persistent grid of `kernel` (the caller has checked the
// geometry against the kernel's shared-memory layout).
template <typename K>
int launch_grid(K kernel, Args a, int threads, int smem_bytes,
                cudaStream_t stream) {
  a.d.ksplit = ksplit_of(a.d, threads);
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

// Whether a launch's scalars and geometry are in range.
inline bool launch_ok(const Args& a, int threads) {
  return a.d.tile > 0 && a.d.tile % a.d.ri == 0 && threads >= a.d.tile &&
         threads % 32 == 0 && threads <= 256 && a.B > 0 && a.max_iter >= 1 &&
         a.counter != nullptr;
}

// The kernel of the operators' placement (GOPS when they are read from
// device memory) and register tile: 8 slots, or 4 with GOPS only.
template <typename K>
int launch(K kernel_smem, K kernel_gops, K kernel_gops4, Args a,
           int threads, int smem_bytes, cudaStream_t stream) {
  if (a.d.ri != 8 && !(a.d.ri == 4 && a.d.gops)) return -1;
  const K kernel = a.d.ri == 4 ? kernel_gops4
                               : (a.d.gops ? kernel_gops : kernel_smem);
  if (smem_bytes != make_layout(a.d).total * 4 || !launch_ok(a, threads))
    return -1;
  return launch_grid(kernel, a, threads, smem_bytes, stream);
}

#if !ATM_SPLIT
// K1's own body (fixed_waves.cuh), at either placement; refused where it
// does not take the launch (wave_fits: over-relaxed solves among them). With
// the operators in shared memory, the quadrotor (DuP 36, DzP 156) and the
// lander (44, 132) at the depth splits of their usual geometries run
// instantiations compiled for them (unrolled products, the same sums).
inline int launch_waves(Args a, int threads, int smem_bytes,
                        cudaStream_t stream) {
  if (!wave_fits(a.d, threads, a.alpha) || !launch_ok(a, threads) ||
      smem_bytes != make_wave_layout(a.d).total * 4)
    return -1;
  void (*kernel)(Args) = a.d.gops ? fused_solve_fixed_kernel<true, 8, true>
                                  : fused_solve_fixed_kernel<false, 8, true>;
  const int H = ksplit_of(a.d, threads);
#define ATM_WAVE_SHAPE(U, Z, HH)                                  \
  if (!a.d.gops && a.d.DuP == U && a.d.DzP == Z && H == HH)       \
    kernel = fused_solve_fixed_kernel<false, 8, true, U, Z, HH>;
  ATM_WAVE_SHAPE(36, 156, 4)
  ATM_WAVE_SHAPE(36, 156, 8)
  ATM_WAVE_SHAPE(44, 132, 2)
  ATM_WAVE_SHAPE(44, 132, 4)
#undef ATM_WAVE_SHAPE
  return launch_grid(kernel, a, threads, smem_bytes, stream);
}
#endif

#if ATM_SPLIT
// The split-bf16 operator fragments (split_words in admm_iteration.cuh) of
// Wf^T and Wb^T, split once per launch into device memory: one thread per
// word. The TPU package splits its operators once per kernel launch too
// (ops/fused_admm.py _make_ws).
__global__ void split_operators_kernel(const float* Wf, const float* Wb,
                                       Dims d, uint32_t* out) {
  const int mtf = split_mt_f(d), ktf = split_kt_f(d), ktb = split_kt_b(d);
  const int nf = 256 * mtf * ktf;
  const int total = split_words(d);
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < total;
       w += gridDim.x * blockDim.x) {
    const bool fwd = w < nf;
    const int v = fwd ? w : w - nf;
    const int KT = fwd ? ktf : ktb;
    const int f = v >> 8, r = v & 255;
    const int lane = (r & 127) >> 2, q = r & 3;
    const int mt = f / KT, kt = f - mt * KT;
    // register q of lane (g, t): row g (+ 8 for q odd), depth 2t, 2t + 1
    // (+ 8 for q >= 2)
    const int m = mt * 16 + (lane >> 2) + (q & 1 ? 8 : 0);
    const int k = kt * 16 + 2 * (lane & 3) + (q & 2 ? 8 : 0);
    auto at = [&](int k_) {   // A[m][k_] = Op[k_][m], zero outside
      if (fwd)
        return m < d.Dz && k_ < d.Du ? Wf[(size_t)k_ * d.DzP + m] : 0.0f;
      return m < d.Du && k_ < d.Dz ? Wb[(size_t)k_ * d.DuP + m] : 0.0f;
    };
    uint32_t hi, lo;
    split_pair(at(k), at(k + 1), hi, lo);
    out[w] = r >= 128 ? lo : hi;
  }
}

// Split the operators for this launch (on the launch's stream), then launch.
// A launch whose schedule splits no iteration (w3 == nullptr: d.split = 0)
// has no fragments to split and lays its shared memory out without them.
template <typename K>
int launch_split(K kernel_smem, K kernel_gops, K kernel_gops4, Args a,
                 int threads, int smem_bytes, cudaStream_t stream) {
  if (a.d.split) {
    const int total = split_words(a.d);
    split_operators_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
        a.Wf, a.Wb, a.d, a.W3);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch(kernel_smem, kernel_gops, kernel_gops4, a, threads,
                smem_bytes, stream);
}
#define ATM_LAUNCHER launch_split
#else
#define ATM_LAUNCHER launch
#endif

}  // namespace atm

// The instantiations of one kernel, launched with the caller's geometry.
#define ATM_LAUNCH(k)                                                  \
  atm::ATM_LAUNCHER(atm::ATM_KNAME(k)<false, 8>,                       \
                    atm::ATM_KNAME(k)<true, 8>,                        \
                    atm::ATM_KNAME(k)<true, 4>, a, threads, smem_bytes, st)

extern "C" {

// Bytes of dynamic shared memory one block needs (the layout's own count).
// ncp: cones with per-instance mu/shift rows (0 when the values are static).
// ops_global: the operators are read from device memory (not staged).
int atm_fused_smem_bytes(int nx, int nu, int N, int tile, int ncp,
                         int ops_global) {
  return atm::make_layout(atm::make_dims(nx, nu, N, tile, ncp,
                                         ops_global != 0, 8, ATM_SPLIT))
             .total * 4;
}

// Bytes of dynamic shared memory of K1's own body (fixed_waves.cuh; 0 in
// the split-bf16 library, which runs K1 on the shared body).
int atm_fused_fixed_smem_bytes(int nx, int nu, int N, int tile,
                               int ops_global) {
  return ATM_SPLIT ? 0
                   : atm::make_wave_layout(atm::make_dims(
                         nx, nu, N, tile, 0, ops_global != 0, 8, 0))
                             .total * 4;
}

// Words of the split-bf16 operator fragments (the scratch the bf16x3 entries
// take as w3; 0 for the float32 kernels).
int atm_fused_split_words(int nx, int nu, int N) {
  return ATM_SPLIT ? atm::split_words(atm::make_dims(nx, nu, N, 8)) : 0;
}


// One batched solve. check_every == 0: fixed max_iter iterations; > 0: the
// adaptive kernel with a check every check_every iterations after warmup.
// cone_idx != nullptr selects the coned instantiation: cone_idx and cone_par
// are the device table (see fill_cones) of nc_u input and nc_x state cones,
// cone_mu / cone_shift device arrays (nc, B) of per-instance values, or both
// nullptr for the static ones; cone_items / cone_chunks the fused cone
// pass's items (see fill_cones; the split-bf16 kernels ignore them). Wf, Wb
// and Wx come padded with zeros (DuP x DzP, DzP x DuP, nx x DzP);
// ops_global != 0: the kernel reads them in place in device memory, else it
// stages them per block in shared memory. ri: slots
// per register tile (8; 4 only with ops_global). w3: the split-bf16 kernels'
// scratch for the operator fragments (atm_fused_split_words words; nullptr
// for the float32 kernels, and for a split-bf16 launch whose schedule splits
// no iteration); n3: a split-bf16 fixed solve's split iterations.
// waves != 0: a fixed box-only float32 solve on K1's own body
// (fixed_waves.cuh; smem_bytes then its layout's), refused (-1) where that
// body does not take the launch; 0: the shared slot body.
int atm_fused_solve(
    const float* x0, const float* D0, const float* Y0, const float* G0,
    const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    const int* cone_idx, const float* cone_par, int nc_u, int nc_x,
    const float* cone_mu, const float* cone_shift, const int* cone_items,
    int cone_chunks, int* counter,
    int B, int nx, int nu, int N, int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, int ops_global, int ri,
    int waves, uint32_t* w3, int n3, void* stream) {
  atm::Args a = {};
  a.W3 = w3; a.n3 = n3;
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
  if (waves && (cone_idx != nullptr || check_every > 0 || ATM_SPLIT))
    return -1;
  if (cone_idx != nullptr) {
    a.d = atm::make_dims(nx, nu, N, tile,
                         cone_mu != nullptr ? nc_u + nc_x : 0, ops_global, ri,
                         ATM_SPLIT && w3 != nullptr);
    if (!atm::fill_cones(a, cone_idx, cone_par, nc_u, nc_x, cone_mu,
                         cone_shift, cone_items, cone_chunks))
      return -1;
    if (check_every > 0)
      return ATM_LAUNCH(fused_solve_adaptive_cones);
    return ATM_LAUNCH(fused_solve_fixed_cones);
  }
  a.d = atm::make_dims(nx, nu, N, tile, 0, ops_global, ri,
                       ATM_SPLIT && w3 != nullptr);
  if (check_every > 0)
    return ATM_LAUNCH(fused_solve_adaptive);
#if !ATM_SPLIT
  if (waves) return atm::launch_waves(a, threads, smem_bytes, st);
#endif
  return ATM_LAUNCH(fused_solve_fixed);
}

// One mission of `ticks` receding-horizon ticks. tracking != 0: cd is
// (ticks, Du), one row per tick; else (Du). cone_idx / cone_par / nc_u /
// nc_x, cone_items / cone_chunks, ops_global and ri as in atm_fused_solve
// (static cone parameters only).
int atm_fused_rollout(
    const float* x0, const float* D0, const float* Z0, const float* V0,
    const float* Wf, const float* Wb, const float* Wx, const float* cd,
    const float* lo, const float* hi, const float* A, const float* Bm,
    float* us, int* iters, float* x_final,
    float* U, float* X, float* D, float* Y, float* G, float* Z, float* V,
    float* stats,
    const int* cone_idx, const float* cone_par, int nc_u, int nc_x,
    const int* cone_items, int cone_chunks, int* counter,
    int B, int nx, int nu, int N, int ticks, int tracking,
    int max_iter, int check_every, int warmup,
    float rho, float alpha, float pri_tol, float dua_tol,
    int tile, int threads, int smem_bytes, int ops_global, int ri,
    uint32_t* w3, int n3, void* stream) {
  if (ticks < 1) return -1;
  atm::Args a = {};
  a.W3 = w3; a.n3 = n3;
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
  a.d = atm::make_dims(nx, nu, N, tile, 0, ops_global, ri,
                       ATM_SPLIT && w3 != nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool adaptive = check_every > 0;
  if (cone_idx != nullptr) {
    if (!atm::fill_cones(a, cone_idx, cone_par, nc_u, nc_x, nullptr,
                         nullptr, cone_items, cone_chunks))
      return -1;
    return adaptive
        ? ATM_LAUNCH(fused_rollout_cones)
        : ATM_LAUNCH(fused_rollout_fixed_cones);
  }
  return adaptive
      ? ATM_LAUNCH(fused_rollout)
      : ATM_LAUNCH(fused_rollout_fixed);
}

}  // extern "C"

#undef ATM_LAUNCH
#undef ATM_LAUNCHER
#undef ATM_KNAME
