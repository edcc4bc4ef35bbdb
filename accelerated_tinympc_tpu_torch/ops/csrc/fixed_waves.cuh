// K1's own body for Hopper (sm_90a): the fixed-iteration, box-only,
// float32 batched solve (fused_solve_fixed_kernel, the "waves" path of
// ops/fused_admm.py fixed_path), in place of the shared slot body of
// admm_iteration.cuh (run_block), which K1 keeps at the shapes this body
// does not take.
//
// Replaces accelerated_tinympc_tpu/ops/fused_admm.py _kernel_fixed (the
// fixed-iteration core of the TPU kernel), as run_block does.
//
// What bounds it on this card: operations (FP32 FMA; the bytes that must
// move are one read of the warm start and one write of the result per
// solve). What held the shared body back in a fixed solve was not the FMA
// rate but what a slot does around it: a slot's dual, slack (double
// buffered) and x0 terms live in shared memory, and every iteration the
// thread that owns a forward register tile reads and writes them (3 float4
// loads and 3 stores per row), reads each row's done, flags and zpar words
// and dispatches on them, and the block keeps per-slot iteration counters
// for an early exit a fixed solve never takes. This body runs the slots of
// a block in lockstep instead:
//
//   * Waves. A block takes `tile` consecutive instances from the work
//     counter at once, runs all of them for exactly max_iter iterations
//     and writes their results, then takes the next wave. The iteration
//     number is one register; the recording and result iteration is
//     it == max_iter for the whole block. A partly filled last wave runs its
//     empty slots on zeros (their rows depend on nothing else: position
//     independence) and writes nothing of them.
//   * Each thread's iterates in its registers. There is one forward item
//     (RI = 8 slots x TJ = 4 columns of z) per thread (the body takes a
//     launch only where the block's items fit its threads, fixed_path), and
//     that item's dual, slack and x0 terms stay in the thread's registers
//     for the whole wave (96 floats), beside its columns' bounds. The
//     forward stage reads only D (and Wf) from shared memory and writes only
//     S, which the backward product reads; the old slack of the dual
//     residual is the register before the update, so no slack buffer is
//     doubled. On the wave's last iteration the thread
//     writes U and X, and after it the carry (duals, slacks) and its share
//     of the residual maxima, straight from its registers.
//   * Shared memory keeps the operators (unless read from device memory,
//     GOPS), the bounds, one const_d row, and per slot D, S and x0.
//   * The wave boundary: every thread loads its own item's dual and slack
//     rows from device memory and forms its x0 terms (the same FMA chain
//     as slot_xbub) while D and x0 rows are staged by the block, so the
//     next wave starts after one round of loads rather than a warp-per-slot
//     chain of them.
//
// Same arithmetic, same order: the forward product is forward_product (one
// FMA chain over k), the backward product backward_product with the same
// depth split and butterfly, the elementwise stage the same expressions,
// the residual maxima a max over the same terms. So a launch gives the
// shared body's bits at the same geometry (tile and threads set the
// backward product's depth split), which the wrapper keeps.

#pragma once
#include "admm_iteration.cuh"

namespace atm {

// Offsets, in 4-byte words, of the wave body's dynamic shared memory. The
// Python wrapper mirrors `total` (ops/fused_admm.py fixed_smem_bytes).
struct WaveLayout {
  int Wf, Wb, lo, hi, cd, D, S, x0, res, wave, total;
};

__host__ __device__ inline WaveLayout make_wave_layout(const Dims& d) {
  WaveLayout L;
  int o = 0;
  const int t = d.tile;
  const int staged = d.gops ? 0 : 1;
  L.Wf = o;   o += staged * d.DuP * d.DzP;
  L.Wb = o;   o += staged * d.DzP * d.DuP;
  L.lo = o;   o += d.DzP;
  L.hi = o;   o += d.DzP;
  L.cd = o;   o += d.DuP;            // const_d, shared by the batch
  L.D = o;    o += t * d.DuP;
  L.S = o;    o += t * d.DzP;
  L.x0 = o;   o += r4(t * d.nx);
  L.res = o;  o += r4(t * 4);        // residual maxima (int views)
  L.wave = o; o += 4;                // the wave's first instance
  L.total = o;
  return L;
}

// Whether the wave body takes a launch: register tiles of 8 slots, one
// forward item a thread, and no over-relaxation (the body has none: nvcc
// contracts alpha x + (1 - alpha) z into FMAs differently in the two
// bodies, so an over-relaxed solve keeps the shared body's bits by running
// there). The wrapper's fixed_path mirrors this.
__host__ __device__ inline bool wave_fits(const Dims& d, int threads,
                                          float alpha) {
  return d.ri == 8 && d.split == 0 && alpha == 1.0f &&
         (d.tile / 8) * (d.DzP / TJ) <= threads;
}

// The results of the wave of n instances from b0: from each item's
// registers the carry's duals and slacks (rows of slots i0 + r < n), from
// shared memory D and the statistics of a fixed solve (iterations, solved
// = 0, the recorded residual maxima, the dual ones times rho).
template <int RI>
__device__ __forceinline__ void write_wave(
    const Args& a, const Dims& d, int b0, int n, bool owner, int i0, int j0,
    const float (&y)[RI][TJ], const float (&z)[RI][TJ], const float* sD,
    const int* res) {
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    if (!owner || i0 + r >= n) continue;
    const int b = b0 + i0 + r;
#pragma unroll
    for (int c = 0; c < TJ; ++c) {
      const int j = j0 + c;
      if (j < d.Dx) {
        a.G[(size_t)b * d.Dx + j] = y[r][c];
        a.V[(size_t)b * d.Dx + j] = z[r][c];
      } else if (j < d.Dz) {
        a.Y[(size_t)b * d.Du + (j - d.Dx)] = y[r][c];
        a.Z[(size_t)b * d.Du + (j - d.Dx)] = z[r][c];
      }
    }
  }
  for (int e = tid; e < n * d.Du; e += nt) {
    const int i = e / d.Du, c = e - i * d.Du;
    a.D[(size_t)(b0 + i) * d.Du + c] = sD[i * d.DuP + c];
  }
  for (int e = tid; e < n * 6; e += nt) {
    const int i = e / 6, q = e - i * 6;
    float v = q == 0 ? (float)a.max_iter : 0.0f;
    if (q >= 2) {
      v = __int_as_float(res[i * 4 + q - 2]);
      if (q == 3 || q == 5) v *= a.rho;
    }
    a.stats[(size_t)(b0 + i) * 6 + q] = v;
  }
}

// KDU, KDZ, KH: DuP, DzP and the backward depth split known at compile time
// (the shapes launch_waves compiles; 0: read from a.d).
template <bool GOPS, int KDU = 0, int KDZ = 0, int KH = 0>
__device__ inline void run_waves(const Args& a, float* base) {
  constexpr int RI = 8;
  const Dims& d = a.d;
  const WaveLayout L = make_wave_layout(d);
  const int DuP = KDU ? KDU : d.DuP, DzP = KDZ ? KDZ : d.DzP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  float* const sD = base + L.D;
  float* const sS = base + L.S;
  float* const sx0 = base + L.x0;
  float* const scd = base + L.cd;
  int* const res = reinterpret_cast<int*>(base + L.res);
  int* const wave = reinterpret_cast<int*>(base + L.wave);
  // forward_product reads D and Wf through an Smem
  Smem s = {};
  s.D = sD;
  s.Wf = GOPS ? a.Wf : base + L.Wf;
  const float* const Wb = GOPS ? a.Wb : base + L.Wb;

  ATM_CLK_BEGIN();
  if (!GOPS) {
    for (int i = tid; i < DuP * DzP; i += nt) base[L.Wf + i] = a.Wf[i];
    for (int i = tid; i < DzP * DuP; i += nt) base[L.Wb + i] = a.Wb[i];
  }
  for (int i = tid; i < DzP; i += nt) {   // zero past Dz, Du
    base[L.lo + i] = i < d.Dz ? a.lo[i] : 0.0f;
    base[L.hi + i] = i < d.Dz ? a.hi[i] : 0.0f;
  }
  for (int i = tid; i < DuP; i += nt) scd[i] = i < d.Du ? a.cd[i] : 0.0f;

  // This thread's forward item: slots i0..i0+7, columns j0..j0+3.
  const int ncg = DzP / TJ;
  const int nitems = ncg * (d.tile / RI);
  const bool owner = tid < nitems;
  const int g = owner ? tid / ncg : 0;
  const int i0 = g * RI, j0 = owner ? (tid - g * ncg) * TJ : 0;
  __syncthreads();
  // its columns' bounds, for every wave
  float lo[TJ], hi[TJ];
#pragma unroll
  for (int c = 0; c < TJ; ++c) {
    lo[c] = base[L.lo + j0 + c];
    hi[c] = base[L.hi + j0 + c];
  }
  // The backward product's tiles of RI slots x TJ columns of D, each summed
  // by H lanes of one warp (backward_stage's depth split). The H lanes of a
  // tile lie 32 / H apart (lane = h * 32 / H + the tile's place in the
  // warp's 32 / H tiles), so the 8 lanes of a quarter warp read one row of
  // Wb for 8 tiles (8 adjacent float4, no bank conflict; with adjacent
  // lanes, as backward_stage's, the rows of lanes h and h + 2 share banks
  // at the quadrotor's DuP = 36); their partial sums meet in the same
  // butterfly tree as adjacent lanes' (the same sums, bit for bit).
  const int H = KH ? KH : d.ksplit;
  const int ncb = DuP / TJ;
  const int btiles = ncb * (d.tile / RI);
  const int TW = 32 / H;   // tiles a warp holds
  const int tw = lane & (TW - 1);
  const int hl = lane / TW;
  const int nwarps = nt >> 5;
  ATM_CLK_MARK();

  // The iterates of this thread's item: duals (Y | G), slacks (Z | V) and
  // x0 terms, one wave at a time.
  float y[RI][TJ], z[RI][TJ], xb[RI][TJ];
  int b0 = -1, n = 0;   // the running wave: n instances from b0
  for (;;) {
    // ---- wave boundary: the last wave's results, then the next wave
    ATM_SCLK_BEGIN();
    if (b0 >= 0) write_wave(a, d, b0, n, owner, i0, j0, y, z, sD, res);
    ATM_SCLK_MID();
    if (tid == 0) wave[0] = atomicAdd(a.counter, d.tile);
    __syncthreads();   // the results read; the claim
    b0 = wave[0];
    if (b0 >= a.B) {   // block-uniform
      ATM_SCLK_END(false);
      ATM_CLK(4);
      break;
    }
    n = min(d.tile, a.B - b0);
    for (int i = tid; i < d.tile * 4; i += nt) res[i] = 0;
    for (int e = tid; e < d.tile * DuP; e += nt) {
      const int i = e / DuP, c = e - i * DuP;
      sD[e] = i < n && c < d.Du ? __ldg(a.D0 + (size_t)(b0 + i) * d.Du + c)
                                : 0.0f;
    }
    for (int e = tid; e < d.tile * d.nx; e += nt) {
      const int i = e / d.nx;
      sx0[e] = i < n ? __ldg(a.x0 + (size_t)b0 * d.nx + e) : 0.0f;
    }
    // the item's rows, zero past Dz and for the empty slots of the wave
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int c = 0; c < TJ; ++c) y[r][c] = z[r][c] = 0.0f;
      if (!owner || i0 + r >= n) continue;
      const int b = b0 + i0 + r;
#pragma unroll
      for (int c = 0; c < TJ; ++c) {
        const int j = j0 + c;
        if (j < d.Dx) {
          y[r][c] = __ldg(a.G0 + (size_t)b * d.Dx + j);
          z[r][c] = __ldg(a.V0 + (size_t)b * d.Dx + j);
        } else if (j < d.Dz) {
          y[r][c] = __ldg(a.Y0 + (size_t)b * d.Du + (j - d.Dx));
          z[r][c] = __ldg(a.Z0 + (size_t)b * d.Du + (j - d.Dx));
        }
      }
    }
    __syncthreads();   // the staged D and x0 rows, the cleared maxima
    // x0 terms Xb = x0 Wx: per element one FMA chain over k in order from
    // zero (slot_xbub's); zero past Dz
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < TJ; ++c) xb[r][c] = 0.0f;
    for (int k = 0; k < d.nx; ++k) {
      const float4 w4 =
          __ldg(reinterpret_cast<const float4*>(a.Wx + k * DzP + j0));
      const float w[TJ] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float xk = sx0[(i0 + r) * d.nx + k];
#pragma unroll
        for (int c = 0; c < TJ; ++c) xb[r][c] = fmaf(xk, w[c], xb[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < TJ; ++c)
      if (j0 + c >= d.Dz) {
#pragma unroll
        for (int r = 0; r < RI; ++r) xb[r][c] = 0.0f;
      }
    ATM_SCLK_END(false);
    ATM_CLK(4);

    for (int it = 1; it <= a.max_iter; ++it) {
      ATM_CLK_COUNT(7);
      ATM_WCLK_BEGIN();
      // ---- forward: product, box clip, dual ascent, S = slack - dual
      float acc[RI][TJ];
      forward_product<RI, GOPS, KDU, KDZ>(d, s, i0, j0, owner, acc);
      // LAST: the wave's last iteration also writes U, X and records the
      // residual maxima (pri_x, dua_x, pri_u, dua_u as int views)
      auto finish = [&](auto last_tag) {
        constexpr bool LAST = decltype(last_tag)::value;
        const unsigned peers =
            LAST ? __match_any_sync(0xffffffffu, owner ? g : -1) : 0u;
        const bool leader = LAST && lane == __ffs(peers) - 1;
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int i = i0 + r;
          int mx[4] = {0, 0, 0, 0};
          float o3[TJ];
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            const int j = j0 + c;
            const float zo = z[r][c];
            const float xu = xb[r][c] + acc[r][c];   // pre-projection X or U
            const float t = xu + y[r][c];
            const float zn = fminf(fmaxf(t, lo[c]), hi[c]);  // box clip
            const float o1 = t - zn;                         // dual ascent
            o3[c] = zn - o1;                                 // S
            y[r][c] = o1;
            z[r][c] = zn;
            if (LAST && j < d.Dz) {
              if (owner && i < n) {
                const size_t b = b0 + i;
                if (j < d.Dx) a.X[b * d.Dx + j] = xu;
                else a.U[b * d.Du + (j - d.Dx)] = xu;
              }
              const int o = j < d.Dx ? 0 : 2;
              mx[o] = max(mx[o], __float_as_int(fabsf(xu - zn)));
              mx[o + 1] = max(mx[o + 1], __float_as_int(fabsf(zo - zn)));
            }
          }
          if (owner)
            *reinterpret_cast<float4*>(sS + i * DzP + j0) =
                make_float4(o3[0], o3[1], o3[2], o3[3]);
          if (LAST) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = __reduce_max_sync(peers, mx[q]);
              if (leader && owner && m > 0) atomicMax(&res[i * 4 + q], m);
            }
          }
        }
      };
      if (it == a.max_iter) finish(std::true_type{});
      else finish(std::false_type{});
      ATM_WCLK(11);
      __syncthreads();
      ATM_CLK(0);
      // ---- backward: D = S Wb + const_d
      ATM_WCLK_BEGIN();
      for (int tb = (tid >> 5) * TW; tb < btiles; tb += nwarps * TW) {
        const bool active = tb + tw < btiles;   // the warp's passes agree
        const int tile = active ? tb + tw : tb;
        const int gb = tile / ncb, cb = tile - gb * ncb;
        const int bi0 = gb * RI, c0 = cb * TJ;
        float bacc[RI][TJ];
        backward_product<RI, GOPS, KDU, KDZ, KH>(d, sS + bi0 * DzP, Wb + c0,
                                                 hl, bacc);
        for (int off = TW; off < 32; off <<= 1) {
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c)
              bacc[r][c] += __shfl_xor_sync(0xffffffffu, bacc[r][c], off);
        }
        if (active && hl == 0) {
          const float4 cd = *reinterpret_cast<const float4*>(scd + c0);
#pragma unroll
          for (int r = 0; r < RI; ++r)
            *reinterpret_cast<float4*>(sD + (bi0 + r) * DuP + c0) =
                make_float4(bacc[r][0] + cd.x, bacc[r][1] + cd.y,
                            bacc[r][2] + cd.z, bacc[r][3] + cd.w);
        }
      }
      ATM_WCLK(13);
      __syncthreads();
      ATM_CLK(3);
    }
  }
  ATM_CLK_END();
}

}  // namespace atm
