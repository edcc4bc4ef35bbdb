// Shared iteration body of the fused ADMM kernels (fixed solve, adaptive
// solve, in-kernel rollout) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bodies of the JAX package:
//   accelerated_tinympc_tpu/ops/fused_admm.py  _iteration / _fixed_core /
//   _adaptive_core, and the tick body of ops/fused_rollout.py _kernel_rollout.
//
// What bounds it on this card: operations. One iteration of one instance is
// two small products that depend on the previous iteration (forward D Wf,
// backward S Wb: 2*(Du*Dx + Du*Du + Dx*Du + Du*Du) FLOP, 22,464 at nx=12,
// nu=4, N=10), while the bytes that must move are one read of the warm
// start and one write of the result per *solve*. So the design keeps
// everything on the SM:
//
//   * The operators are two matrices over z = [x | u] (width Dz = Dx + Du),
//     in float32:
//       Wf = [W_fd | W_gd] (Du x Dz)  maps D -> [X | U],
//       Wb = [W_q ; W_r]   (Dz x Du)  maps S -> D.
//     The wrapper passes them padded with zero rows and columns to
//     multiples of 4 (DuP x DzP, DzP x DuP, nx x DzP). Two placements
//     (template parameter GOPS). Where they fit beside one register tile of
//     slots, they are staged once per block into dynamic shared memory.
//     Past that (the quadrotor beyond N = 18) the kernels read them in place
//     from device memory, where they stay resident in the 50 MB L2; shared
//     memory then holds only the bounds and the per-slot state. Every
//     product sums in the same order in both placements, so where both fit
//     they give the same bits (at one launch geometry).
//   * Persistent blocks of slots. The grid is as many blocks as the SMs hold
//     at once; a block owns `tile` slots, and a global work counter (one
//     int, zeroed by the wrapper before each launch) hands each slot the
//     next unstarted instance. A slot keeps its own iteration counter, so
//     warmup, checks, the recording check and the iteration cap are decided
//     per slot. When a slot's instance freezes at a check or reaches the cap
//     the block retires it (results and carry to device memory) and loads
//     the next one into the slot; in the rollout a slot carries an
//     (instance, tick) pair and only moves its own instance to the next
//     tick. No instance waits for another, and there is no partly filled
//     last wave.
//   * Products by FP32 FMA out of shared memory. What limits them is not
//     the FMA rate alone but the 128 B/clk an SM can return from shared
//     memory to registers. So each thread owns a register tile of RI = 8
//     slots x TJ = 4 adjacent columns: per step of four k it loads 8 + 4
//     float4 and does 128 FMAs (1.5 B/FMA). Where one tile of 8 slots'
//     state does not fit shared memory even with the operators in device
//     memory (the quadrotor past N = 78), the kernels take RI = 4 (template
//     parameter): 4 + 4 float4 for 64 FMAs. A slot's arithmetic does not
//     depend on RI, so both give the same bits at one launch geometry. The
//     backward product has few columns (Du/4 column groups), so its depth
//     Dz is split over H adjacent lanes whose partial sums meet in a shuffle
//     reduction. (A split-operand
//     TF32 product on the tensor cores, mma.sync m16n8k8 in three passes,
//     was measured on an H100 in this design's place and lost: PERF.md.)
//   * Position independence: a slot row's arithmetic depends only on its own
//     data (a register tile row does not see the other rows, the residual
//     maxima reduce by max, every sum's order is fixed), so a permuted batch
//     gives the permuted result bit for bit.
//   * The forward product, the box clip, the dual update and the residual
//     terms are fused: the thread that finishes X[i][j] (or U) clips it,
//     updates the dual and writes S[i][j] = slack - dual for the backward
//     product.
//   * Early exit is per slot: a frozen slot stops being written (its shared
//     memory *is* its result: D and the slacks from before the check
//     iteration, the duals from after it); its U and X are recomputed from
//     the D it kept, in the forward product's summation order. A register
//     tile group whose slots are all done skips its products.
//   * A check costs no reduction: max_j r_j < tol holds exactly when no term
//     reaches the tolerance, so each lane only raises a flag for a slot it
//     sees violated. The residual maxima are reduced on the recording
//     iteration (the last check, or the last iteration of a fixed solve)
//     and, for a frozen slot, when it is retired.
//   * Slacks are double-buffered per slot (zpar) so that the check
//     iteration can read the old slack for the dual residual and still leave
//     it in place for a slot that freezes.
//
//   * Second-order cones (template parameter CONES; replaces the TPU
//     package's _cone_apply, ops/fused_admm.py) couple the ball and axis
//     entries of one knot, which sit in different threads' register tiles.
//     So with cones the stage splits in three with a barrier between: the
//     forward product clips as before and leaves the pre-projection iterate
//     (in S), the relaxed iterate + old dual (in YG) and the clipped slack
//     (in the new slack buffer) in shared memory; a cone pass with one
//     thread per (slot, knot) projects the clipped slack in place, each cone
//     in order (exact projection, three cases); an elementwise pass does dual
//     ascent, S = slack - dual, the residual terms and the violation flag
//     against the projected slack. The box-only instantiations keep the fused
//     per-element path.
//
// Stage order per iteration is the reference's (src/tinympc/admm.cpp:117-150)
// in its folded condensed form: forward (x0 terms hoisted into XbUb), slack
// projection (fminf/fmaxf, safe with infinite bounds), dual ascent, then the
// linear-cost and backward stages as the single product against Wb plus the
// hoisted const_d.

#pragma once
#include <cuda_runtime.h>
#include <type_traits>

namespace atm {

// Slots per register tile (RI, a template parameter: 8, or 4 where 8 do
// not fit; tile % RI == 0) and adjacent columns per register tile.
constexpr int TJ = 4;  // one float4
// Retire and refill once this many slots wait (or no slot is live): a
// refill costs two barriers, and on an H100 batching 8 beat refilling at
// every iteration (PERF.md). The 4-slot tile runs only past N = 78 on the
// quadrotor, where one iteration's products take far longer than a refill
// (a refill loads one slot and forms its Xb, nx x Dz FMAs by one warp,
// against tile x Du x Dz FMAs by the block for the forward product alone),
// and a waiting slot is a quarter of the block idle: it refills at once.
template <int RI>
__host__ __device__ constexpr int refill_min() { return RI == 8 ? 8 : 1; }
// The backward product's depth (Dz, 636 at N=40) sums in blocks of this many
// float4 steps of a lane, each block one FMA chain added to the running sum.
// One chain over a lane's whole depth (318 FMAs at N=40) left the states of
// a cold 100-iteration solve twice as far from float64 as two BLAS-based
// float32 versions; blocks of 128 terms bring it under them (PERF.md). At
// the flagship and the lander a lane's depth is one block, so their sums
// are unchanged.
constexpr int BWD_BLOCK = 32;
constexpr int BWD_FINE = 4;
// On register tiles of 4 slots (the horizons past one tile of 8, the
// quadrotor past N=78) long depths sum in blocks: the forward product's
// past FWD_CHAIN float4 steps in blocks of BWD_BLOCK (like the backward
// product), the backward product's past 4 blocks a lane in blocks of
// BWD_FINE. At N=129, blocks of 32 in the backward product left the states
// 2.1e-4 from float64 where two BLAS-based float32 versions sat at 1.1e-4;
// blocks of 4 reach a BLAS's level (PERF.md). The 8-slot kernels keep their
// sums; where both tiles run (at N <= 64 for the forward product, a lane's
// backward depth up to 4 blocks) the two give the same bits.
constexpr int FWD_CHAIN = 64;

// Slot states (Smem::done).
constexpr int LIVE = 0;    // iterating
constexpr int DONE = 1;    // frozen, waiting to be retired, or idle
constexpr int CAPPED = 2;  // reached the cap this iteration: the backward
                           // stage still runs it, then it is retired
// What a slot's next iteration does (Smem::flags).
constexpr int F_CHECK = 1;   // a convergence check
constexpr int F_RECORD = 2;  // accumulate the residual maxima
constexpr int F_EMIT = 4;    // write U, X to device memory (the slot's last
                             // iteration of its last solve)
// Why a slot is retired (Smem::ret).
constexpr int R_STAY = 0, R_RETIRE = 1, R_RETIRE_EMIT = 2;

struct Dims {
  int nx, nu, N;    // knot widths and horizon
  int Dx, Du, Dz;   // N*nx, (N-1)*nu, Dx+Du
  int DuP, DzP;     // Du, Dz rounded up to 4 (float4 rows, zero padded)
  int tile;         // slots per block
  int ksplit;       // lanes sharing one backward tile's depth (power of 2)
  int ncp;          // cones with per-instance mu/shift rows (0 or all)
  int gops;         // 1: the operators are read from device memory
  int ri;           // slots per register tile (8 or 4)
};

// The cones of one problem, input cones first, then state cones, in device
// memory (any number of cones, any ball size): idx[c] is the offset in idx
// of cone c's row [nball, axis, ball[nball]] (indices inside a knot), par
// holds [mu, shift] per cone, the static values of
// ||w[ball]|| <= mu * (w[axis] + shift).
struct ConeTable {
  int nc_u, nc_x;
  const int* idx;
  const float* par;
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Dims make_dims(int nx, int nu, int N, int tile,
                                          int ncp = 0, int gops = 0,
                                          int ri = 8) {
  Dims d;
  d.nx = nx; d.nu = nu; d.N = N;
  d.Dx = N * nx; d.Du = (N - 1) * nu; d.Dz = d.Dx + d.Du;
  d.DuP = r4(d.Du); d.DzP = r4(d.Dz);
  d.tile = tile;
  d.ksplit = 1;
  d.ncp = ncp;
  d.gops = gops;
  d.ri = ri;
  return d;
}

// Offsets, in 4-byte words, of every region of the block's dynamic shared
// memory. The Python wrapper mirrors `total` (ops/fused_admm.py,
// kernel_smem_bytes) and the C entry refuses a launch if the two disagree.
struct Layout {
  int Wf, Wb, Wx, lo, hi, A, Bm;               // staged once per block
  int D, cd, S, YG, ZV, Xb, x0, u0, stat;      // per-slot floats
  int res, done, zpar, viol, itc, flags, inst, tick, ret, list, nref;
  int cmu, csh;                                // per-slot cone mu, shift
  int total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = 0;
  const int t = d.tile;
  const int staged = d.gops ? 0 : 1;  // operators in shared memory
  L.Wf = o;   o += staged * d.DuP * d.DzP;  // k rows; past Du, Dz zero
  L.Wb = o;   o += staged * d.DzP * d.DuP;
  L.Wx = o;   o += staged * d.nx * d.DzP;
  L.lo = o;   o += d.DzP;
  L.hi = o;   o += d.DzP;
  L.A = o;    o += r4(d.nx * d.nx);
  L.Bm = o;   o += r4(d.nx * d.nu);
  L.D = o;    o += t * d.DuP;
  L.cd = o;   o += t * d.DuP;        // the slot's const_d row
  L.S = o;    o += t * d.DzP;
  L.YG = o;   o += t * d.DzP;
  L.ZV = o;   o += 2 * t * d.DzP;
  L.Xb = o;   o += t * d.DzP;
  L.x0 = o;   o += r4(t * d.nx);
  L.u0 = o;   o += r4(t * d.nu);
  L.stat = o; o += r4(t * 6);
  L.res = o;  o += r4(t * 4);
  L.done = o; o += t;
  L.zpar = o; o += t;
  L.viol = o; o += t;
  L.itc = o;  o += t;
  L.flags = o; o += t;
  L.inst = o; o += t;
  L.tick = o; o += t;
  L.ret = o;  o += t;
  L.list = o; o += t;
  L.nref = o; o += 4;
  L.cmu = o;  o += r4(d.ncp * t);       // [cone][slot]
  L.csh = o;  o += r4(d.ncp * t);
  L.total = o;
  return L;
}

// Everything a kernel needs; filled by the C entries in fused_admm.cu.
struct Args {
  // inputs, (B, .) row-major, unpadded
  const float *x0, *D0, *Y0, *G0, *Z0, *V0;
  // operators and vectors shared by the batch
  const float *Wf, *Wb, *Wx;    // (DuP,DzP), (DzP,DuP), (nx,DzP), zero padded
  const float *cd;              // (Du) const_d, or (ticks,Du) when tracking
  const float *lo, *hi;         // (Dz) bounds over z = [x | u]
  const float *A, *Bm;          // plant (nx,nx), (nx,nu); rollout only
  // cones (coned kernels only): the table, and per-instance mu/shift rows
  // (nc,B) over all cones in the table's order, or nullptr for the static
  // values
  ConeTable cones;
  const float *cone_mu, *cone_shift;
  // outputs
  float *U, *X, *D, *Y, *G, *Z, *V, *stats;   // stats (B,6)
  float *us;                    // (ticks,B,nu)  rollout only
  int *iters;                   // (ticks,B)     rollout only
  float *x_final;               // (B,nx)        rollout only
  int *counter;                 // work counter, 0 at launch
  int B, ticks, tracking;
  int max_iter, check_every, warmup;
  float rho, alpha, pri_tol, dua_tol;
  Dims d;
};

struct Smem {
  const float *Wf, *Wb, *Wx;   // shared memory, or device memory (GOPS)
  float *lo, *hi, *A, *Bm;
  float *D, *cd, *S, *YG, *ZV, *Xb, *x0, *u0, *stat;
  int *res, *done, *zpar, *viol, *itc, *flags, *inst, *tick, *ret;
  int *list, *nref;
  float *cmu, *csh;
};

template <bool GOPS>
__device__ inline Smem carve(const Args& a, float* base, const Layout& L) {
  Smem s;
  auto I = [base](int off) { return reinterpret_cast<int*>(base + off); };
  if (GOPS) {
    s.Wf = a.Wf; s.Wb = a.Wb; s.Wx = a.Wx;
  } else {
    s.Wf = base + L.Wf; s.Wb = base + L.Wb; s.Wx = base + L.Wx;
  }
  s.lo = base + L.lo;
  s.hi = base + L.hi; s.A = base + L.A; s.Bm = base + L.Bm;
  s.D = base + L.D; s.cd = base + L.cd; s.S = base + L.S;
  s.YG = base + L.YG; s.ZV = base + L.ZV;
  s.Xb = base + L.Xb; s.x0 = base + L.x0; s.u0 = base + L.u0;
  s.stat = base + L.stat;
  s.res = I(L.res); s.done = I(L.done); s.zpar = I(L.zpar);
  s.viol = I(L.viol); s.itc = I(L.itc); s.flags = I(L.flags);
  s.inst = I(L.inst); s.tick = I(L.tick); s.ret = I(L.ret);
  s.list = I(L.list); s.nref = I(L.nref);
  s.cmu = base + L.cmu; s.csh = base + L.csh;
  return s;
}

// ---------------------------------------------------------------- staging --

// Operator loads: from shared memory, or (GOPS) read-only from device
// memory, where the operators stay resident in L2. The values, and so every
// product, are the same either way.
template <bool GOPS>
__device__ __forceinline__ float4 ldw4(const float* p) {
  if constexpr (GOPS) return __ldg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}
template <bool GOPS>
__device__ __forceinline__ float ldw1(const float* p) {
  if constexpr (GOPS) return __ldg(p);
  else return *p;
}

// Zero all per-slot state, then stage the operators unless they are read
// from device memory (their zero padding rows and columns let the products
// run over the padded widths and keep the padding of every iterate zero).
template <bool GOPS>
__device__ inline void stage_block(const Args& a, const Layout& L,
                                   float* base, const Smem& s) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L.total; i += nt) base[i] = 0.0f;
  __syncthreads();
  if (!GOPS) {
    for (int i = tid; i < d.DuP * d.DzP; i += nt) base[L.Wf + i] = a.Wf[i];
    for (int i = tid; i < d.DzP * d.DuP; i += nt) base[L.Wb + i] = a.Wb[i];
    for (int i = tid; i < d.nx * d.DzP; i += nt) base[L.Wx + i] = a.Wx[i];
  }
  for (int i = tid; i < d.Dz; i += nt) { s.lo[i] = a.lo[i]; s.hi[i] = a.hi[i]; }
  if (a.A != nullptr) {
    for (int i = tid; i < d.nx * d.nx; i += nt) s.A[i] = a.A[i];
    for (int i = tid; i < d.nx * d.nu; i += nt) s.Bm[i] = a.Bm[i];
  }
}

// Flags of a slot's iteration `it` (1-based). final_solve: the slot's
// result is returned (every solve; the last tick of a mission).
template <bool ADAPTIVE>
__device__ inline int iteration_flags(const Args& a, int it, bool final_solve) {
  const bool last = it == a.max_iter;
  const bool check = ADAPTIVE && it > a.warmup && it % a.check_every == 0;
  const bool record =
      ADAPTIVE ? check && it == (a.max_iter / a.check_every) * a.check_every
               : last;
  return (check ? F_CHECK : 0) | (record ? F_RECORD : 0) |
         (last && final_solve ? F_EMIT : 0);
}

// y[j] = sum_k x[k] W[k][j] for j < n (W's rows ldw apart), by one warp,
// each sum in k order (LONG: in blocks of 4 BWD_BLOCK terms, each a fresh
// chain added to the running sum, where K exceeds 4 FWD_CHAIN: the 4-slot
// forward product's order); emit(j, y[j]) takes the results. A lane runs
// the columns lane + 32 q, q < 4, of 128 at once: four independent chains
// hide the latency of the shared-memory loads and of the FMAs.
template <bool GOPS, bool LONG = false, typename Emit>
__device__ inline void warp_row_product(const float* x, int K, const float* W,
                                        int ldw, int n, Emit&& emit) {
  const int lane = threadIdx.x & 31;
  if constexpr (!LONG) {
    for (int j0 = lane; j0 < n; j0 += 128) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float xk = x[k];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + 32 * q < n)
            acc[q] = fmaf(xk, ldw1<GOPS>(W + k * ldw + j0 + 32 * q), acc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + 32 * q < n) emit(j0 + 32 * q, acc[q]);
    }
    return;
  }
  const int blk = (K + 3) / 4 > FWD_CHAIN ? 4 * BWD_BLOCK : K;
  for (int j0 = lane; j0 < n; j0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += blk) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int k1 = min(K, k0 + blk);
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float xk = x[k];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + 32 * q < n)
            part[q] = fmaf(xk, ldw1<GOPS>(W + k * ldw + j0 + 32 * q),
                           part[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = k0 == 0 ? part[q] : acc[q] + part[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + 32 * q < n) emit(j0 + 32 * q, acc[q]);
  }
}

// Hoisted x0 terms of slot i, by one warp: Xb[i][j] = sum_k x0[i][k] Wx[k][j]
// (Wx = [W_fx | W_gx]).
template <bool GOPS>
__device__ inline void slot_xbub(const Args& a, const Smem& s, int i) {
  const Dims& d = a.d;
  float* xb = s.Xb + i * d.DzP;
  warp_row_product<GOPS>(s.x0 + i * d.nx, d.nx, s.Wx, d.DzP, d.Dz,
                   [&](int j, float v) { xb[j] = v; });
}

// ----------------------------------------------------------------- stages --

// Forward product fused with slack projection, dual ascent and residuals.
// A thread owns one (group of RI slots, group of TJ adjacent columns of z)
// register tile at a time. The loop over items is warp-uniform so that the
// residual maxima can reduce with one redux per quantity over the lanes
// that share a slot group. Per slot row, its flags say whether this
// iteration checks (s.viol: raised for a slot with a residual term at or
// above its tolerance), records the four residual maxima or writes U, X to
// device memory. KEEP_U0 (rollout): every iteration leaves the first-knot
// controls in s.u0.
// CONES = true: the stage ends after the box clip; it leaves the
// pre-projection iterate in S (and in u0, U, X where asked), t = relaxed
// iterate + old dual in YG and the clipped slack in the new slack buffer,
// for cone_stage and finish_stage.
template <int RI, bool CONES, bool KEEP_U0, bool GOPS>
__device__ inline void forward_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int ncg = d.DzP / TJ;
  const int nitems = ncg * (d.tile / RI);
  const int zstride = d.tile * d.DzP;
  const float alpha = a.alpha;
  const bool relax = alpha != 1.0f;
  for (int base = 0; base < nitems; base += blockDim.x) {
    const int raw = base + threadIdx.x;
    const bool active = raw < nitems;
    const int item = active ? raw : nitems - 1;
    const int g = item / ncg, cg = item - g * ncg;
    const int i0 = g * RI, j0 = cg * TJ;
    bool dn[RI];
    int fl[RI];
    bool live = false;
    int anyfl = 0;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      dn[r] = !active || s.done[i0 + r] != LIVE;
      fl[r] = dn[r] ? 0 : s.flags[i0 + r];
      live |= !dn[r];
      anyfl |= fl[r];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform
    float acc[RI][TJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < TJ; ++c) acc[r][c] = 0.0f;
    if (live) {
      const float* Dg = s.D + i0 * d.DuP;
      const float* Wc = s.Wf + j0;
      if constexpr (RI == 4) {
        // Blocks of BWD_BLOCK float4 steps past FWD_CHAIN, else one chain
        // (warp_row_product<GOPS, true> sums a frozen slot's U, X alike).
        const int blk = (d.DuP >> 2) > FWD_CHAIN ? 4 * BWD_BLOCK : d.DuP;
        for (int k0 = 0; k0 < d.DuP; k0 += blk) {
          float part[RI][TJ];
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c) part[r][c] = 0.0f;
          const int k1 = min(d.DuP, k0 + blk);
          for (int k = k0; k < k1; k += 4) {
            float w[4][TJ];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 wv = ldw4<GOPS>(Wc + (k + kk) * d.DzP);
              w[kk][0] = wv.x; w[kk][1] = wv.y; w[kk][2] = wv.z;
              w[kk][3] = wv.w;
            }
#pragma unroll
            for (int r = 0; r < RI; ++r) {
              const float4 dv =
                  *reinterpret_cast<const float4*>(Dg + r * d.DuP + k);
#pragma unroll
              for (int c = 0; c < TJ; ++c) {
                part[r][c] = fmaf(dv.x, w[0][c], part[r][c]);
                part[r][c] = fmaf(dv.y, w[1][c], part[r][c]);
                part[r][c] = fmaf(dv.z, w[2][c], part[r][c]);
                part[r][c] = fmaf(dv.w, w[3][c], part[r][c]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c)
              acc[r][c] = k0 == 0 ? part[r][c] : acc[r][c] + part[r][c];
        }
      } else {   // one chain over the depth
        for (int k = 0; k < d.DuP; k += 4) {
          float w[4][TJ];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 wv = ldw4<GOPS>(Wc + (k + kk) * d.DzP);
            w[kk][0] = wv.x; w[kk][1] = wv.y; w[kk][2] = wv.z; w[kk][3] = wv.w;
          }
#pragma unroll
          for (int r = 0; r < RI; ++r) {
            const float4 dv =
                *reinterpret_cast<const float4*>(Dg + r * d.DuP + k);
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
              acc[r][c] = fmaf(dv.x, w[0][c], acc[r][c]);
              acc[r][c] = fmaf(dv.y, w[1][c], acc[r][c]);
              acc[r][c] = fmaf(dv.z, w[2][c], acc[r][c]);
              acc[r][c] = fmaf(dv.w, w[3][c], acc[r][c]);
            }
          }
        }
      }
    }
    const float4 l4 = *reinterpret_cast<const float4*>(s.lo + j0);
    const float4 h4 = *reinterpret_cast<const float4*>(s.hi + j0);
    const float lo[TJ] = {l4.x, l4.y, l4.z, l4.w};
    const float hi[TJ] = {h4.x, h4.y, h4.z, h4.w};
    const bool holds_u0 = j0 < d.Dx + d.nu && j0 + TJ > d.Dx;
    // The elementwise stage, in three versions by the flags of the warp's
    // slots this iteration: none (most iterations of a fixed solve), checks
    // only (most iterations of an adaptive one: the violation test runs on
    // every element, without a per-slot branch), or any.
    auto finish = [&](auto mode_tag) {
      constexpr int MODE = decltype(mode_tag)::value;
      constexpr bool FLAGS = MODE == 2;
      // Lanes of this warp that work on the same slot group: items run with
      // the lanes, so they are the lanes from the group's first item to its
      // last (threads beyond the last item repeat it and count with it).
      const bool rec_any = FLAGS && !CONES &&
                           __any_sync(0xffffffffu, (anyfl & F_RECORD) != 0);
      unsigned peers = 0u;
      if (rec_any) {
        const int item0 = base + (threadIdx.x & ~31);
        const int first = max(g * ncg - item0, 0);
        const int end =
            g == (nitems - 1) / ncg ? 32 : min((g + 1) * ncg - item0, 32);
        peers = (end >= 32 ? 0xffffffffu : (1u << end) - 1u) &
                ~((1u << first) - 1u);
      }
      const bool leader = rec_any && lane == __ffs(peers) - 1;
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = i0 + r;
        const int idx = i * d.DzP + j0;
        int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u (int views)
        bool viol = false;
        if (!dn[r]) {
          const int zp = s.zpar[i];
          const float4 xb4 = *reinterpret_cast<const float4*>(s.Xb + idx);
          const float4 y4 = *reinterpret_cast<const float4*>(s.YG + idx);
          const float4 z4 =
              *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
          const float xb[TJ] = {xb4.x, xb4.y, xb4.z, xb4.w};
          const float yo[TJ] = {y4.x, y4.y, y4.z, y4.w};
          const float zo[TJ] = {z4.x, z4.y, z4.z, z4.w};
          float o1[TJ], zn[TJ], o3[TJ];
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            const int j = j0 + c;
            const float xu = xb[c] + acc[r][c];   // pre-projection X or U
            const float xr =
                relax ? alpha * xu + (1.0f - alpha) * zo[c] : xu;
            const float t = xr + yo[c];
            zn[c] = fminf(fmaxf(t, lo[c]), hi[c]);  // box clip, inf-safe
            if (CONES) {
              o1[c] = t;              // relaxed iterate + old dual
              o3[c] = xu;             // pre-projection iterate
            } else {
              o1[c] = t - zn[c];      // dual ascent
              o3[c] = zn[c] - o1[c];  // S = slack - dual
            }
            // The first-knot controls of every iteration: what a slot
            // keeps is those of its last one (rollout).
            if (KEEP_U0 && holds_u0 && j >= d.Dx && j < d.Dx + d.nu)
              s.u0[i * d.nu + (j - d.Dx)] = xu;
            if (MODE == 1 && !CONES && j < d.Dz)
              viol |= !(fabsf(xu - zn[c]) < a.pri_tol) ||
                      !(fabsf(zo[c] - zn[c]) * a.rho < a.dua_tol);
            if (FLAGS && j < d.Dz) {
              if (fl[r] & F_EMIT) {
                const int b = s.inst[i];
                if (j < d.Dx) a.X[(size_t)b * d.Dx + j] = xu;
                else a.U[(size_t)b * d.Du + (j - d.Dx)] = xu;
              }
              if (!CONES) {
                const float pr = fabsf(xu - zn[c]);
                const float dr = fabsf(zo[c] - zn[c]);
                // max_j(.) < tol  <=>  every term < tol (a NaN fails both).
                if (fl[r] & F_CHECK)
                  viol |= !(pr < a.pri_tol) || !(dr * a.rho < a.dua_tol);
                if (fl[r] & F_RECORD) {
                  // |.| >= 0: the int view orders like the float, NaN on top.
                  const int o = j < d.Dx ? 0 : 2;
                  mx[o] = max(mx[o], __float_as_int(pr));
                  mx[o + 1] = max(mx[o + 1], __float_as_int(dr));
                }
              }
            }
          }
          // Columns beyond Dz are padding: operators, bounds and Xb are zero
          // there, so the stored values stay zero.
          *reinterpret_cast<float4*>(s.YG + idx) =
              make_float4(o1[0], o1[1], o1[2], o1[3]);
          *reinterpret_cast<float4*>(s.ZV + (zp ^ 1) * zstride + idx) =
              make_float4(zn[0], zn[1], zn[2], zn[3]);
          *reinterpret_cast<float4*>(s.S + idx) =
              make_float4(o3[0], o3[1], o3[2], o3[3]);
          if (viol && (fl[r] & F_CHECK)) s.viol[i] = 1;
        }
        if (rec_any) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = __reduce_max_sync(peers, mx[q]);
            if (leader && (fl[r] & F_RECORD) && m > 0)
              atomicMax(&s.res[i * 4 + q], m);
          }
        }
      }
    };
    const unsigned wfl = __reduce_or_sync(0xffffffffu, (unsigned)anyfl);
    if (wfl == 0u) finish(std::integral_constant<int, 0>{});
    else if (wfl == (unsigned)F_CHECK) finish(std::integral_constant<int, 1>{});
    else finish(std::integral_constant<int, 2>{});
  }
}

// Cone projections, one thread per (slot, knot): knots 0..N-1 are the
// state knots, N..2N-2 the input knots. forward_stage<true> has left the
// box-clipped slack in the new slack buffer; each cone of the knot's kind is
// applied to it in order, in place (exact projection of (w[ball], w[axis] +
// shift) onto ||v|| <= mu s: inside -> unchanged, polar -> 0, else the
// boundary point; a == 0 guarded). mu and shift come from the per-slot
// rows when given (d.ncp > 0), else from the table: the arithmetic is the
// same either way. The table is read from device memory (a few hundred
// bytes that stay in L1).
__device__ inline void cone_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const ConeTable& ct = a.cones;
  // Only the knots of a kind that has cones: [k_lo, k_hi).
  const int k_lo = ct.nc_x ? 0 : d.N;
  const int k_hi = ct.nc_u ? 2 * d.N - 1 : d.N;
  const int nk = k_hi - k_lo;
  const int zstride = d.tile * d.DzP;
  for (int item = threadIdx.x; item < d.tile * nk; item += blockDim.x) {
    const int i = item / nk, k = k_lo + item - i * nk;
    if (s.done[i] != LIVE) continue;
    const bool is_x = k < d.N;
    const int j0 = is_x ? k * d.nx : d.Dx + (k - d.N) * d.nu;
    float* zn = s.ZV + (s.zpar[i] ^ 1) * zstride + i * d.DzP + j0;
    const int c0 = is_x ? ct.nc_u : 0;
    const int c1 = is_x ? ct.nc_u + ct.nc_x : ct.nc_u;
    for (int q = c0; q < c1; ++q) {
      const float mu = d.ncp ? s.cmu[q * d.tile + i] : __ldg(ct.par + 2 * q);
      const float shift =
          d.ncp ? s.csh[q * d.tile + i] : __ldg(ct.par + 2 * q + 1);
      const int* row = ct.idx + __ldg(ct.idx + q);
      const int nball = __ldg(row), axis = __ldg(row + 1);
      const int* ball = row + 2;
      float a2 = 0.0f;
      for (int b = 0; b < nball; ++b) {
        const float v = zn[__ldg(ball + b)];
        a2 = fmaf(v, v, a2);
      }
      const float sv = zn[axis] + shift;
      const float an = sqrtf(a2);
      const bool inside = an <= mu * sv;
      const bool polar = mu * an <= -sv;
      const float cc = (mu * an + sv) / (mu * mu + 1.0f);
      const float safe_a = a2 == 0.0f ? 1.0f : an;
      const float scale = polar ? 0.0f : (inside ? 1.0f : mu * cc / safe_a);
      const float s_new = inside ? sv : (polar ? 0.0f : cc);
      for (int b = 0; b < nball; ++b) zn[__ldg(ball + b)] *= scale;
      zn[axis] = s_new - shift;
    }
  }
}

// Closes the coned slack stage, one thread per (slot, group of TJ columns):
// dual ascent against the *projected* slack, S = slack - dual, the residual
// terms, the violation flag and (on the recording iteration) the maxima.
// Reads t = relaxed iterate + old dual from YG, the pre-projection iterate
// from S and the projected slack from the new slack buffer. As in
// forward_stage, the loop over items is warp-uniform and the work runs in
// one of three versions by the flags of the warp's slots: none, checks only
// (the violation test on every element, without a per-slot branch), or any.
__device__ inline void finish_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const int ncg = d.DzP / TJ;
  const int nitems = d.tile * ncg;
  const int zstride = d.tile * d.DzP;
  for (int base = 0; base < nitems; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const int i = min(item, nitems - 1) / ncg;
    const int j0 = (item - i * ncg) * TJ;
    const bool live = item < nitems && s.done[i] == LIVE;
    const int fl = live ? s.flags[i] & (F_CHECK | F_RECORD) : 0;
    const unsigned wfl = __reduce_or_sync(0xffffffffu, (unsigned)fl);
    if (!live) continue;
    auto finish = [&](auto mode_tag) {
      constexpr int MODE = decltype(mode_tag)::value;
      const bool check = MODE == 1 || (MODE == 2 && (fl & F_CHECK));
      const bool record = MODE == 2 && (fl & F_RECORD);
      const int idx = i * d.DzP + j0;
      const int zp = s.zpar[i];
      const float4 x4 = *reinterpret_cast<const float4*>(s.S + idx);
      const float4 t4 = *reinterpret_cast<const float4*>(s.YG + idx);
      const float4 o4 =
          *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
      const float4 n4 =
          *reinterpret_cast<const float4*>(s.ZV + (zp ^ 1) * zstride + idx);
      const float xu[TJ] = {x4.x, x4.y, x4.z, x4.w};
      const float t[TJ] = {t4.x, t4.y, t4.z, t4.w};
      const float zo[TJ] = {o4.x, o4.y, o4.z, o4.w};
      const float zn[TJ] = {n4.x, n4.y, n4.z, n4.w};
      float yn[TJ], sv[TJ];
      int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u as int views
      bool viol = false;
#pragma unroll
      for (int c = 0; c < TJ; ++c) {
        const int j = j0 + c;
        yn[c] = t[c] - zn[c];   // dual ascent
        sv[c] = zn[c] - yn[c];
        if (MODE > 0 && j < d.Dz) {
          const float pr = fabsf(xu[c] - zn[c]);
          const float dr = fabsf(zo[c] - zn[c]);
          if (check) viol |= !(pr < a.pri_tol) || !(dr * a.rho < a.dua_tol);
          if (record) {
            const int o = j < d.Dx ? 0 : 2;
            mx[o] = max(mx[o], __float_as_int(pr));
            mx[o + 1] = max(mx[o + 1], __float_as_int(dr));
          }
        }
      }
      *reinterpret_cast<float4*>(s.YG + idx) =
          make_float4(yn[0], yn[1], yn[2], yn[3]);
      *reinterpret_cast<float4*>(s.S + idx) =
          make_float4(sv[0], sv[1], sv[2], sv[3]);
      if (viol && (fl & F_CHECK)) s.viol[i] = 1;
      if (record) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (mx[q] > 0) atomicMax(&s.res[i * 4 + q], mx[q]);
      }
    };
    if (wfl == 0u) finish(std::integral_constant<int, 0>{});
    else if (wfl == (unsigned)F_CHECK) finish(std::integral_constant<int, 1>{});
    else finish(std::integral_constant<int, 2>{});
  }
}

// One thread per live slot closes the iteration's bookkeeping: count the
// iteration, keep the recorded residuals, freeze the slot if a check flagged
// no violation (it then keeps its old D and old slacks: zpar is not
// flipped, the backward stage skips it), otherwise adopt the new slacks;
// a slot at the cap is marked CAPPED (the backward stage still runs it).
// Either way it is marked for retirement, and its next flags are set.
// Returns 1 for a slot that stays LIVE (thread i < tile), else 0.
template <bool ADAPTIVE, bool ROLLOUT>
__device__ inline int decide_stage(const Args& a, const Smem& s) {
  const int i = threadIdx.x;
  int live = 0;
  if (i < a.d.tile && s.done[i] == LIVE) {
    const int it = s.itc[i] + 1;
    s.itc[i] = it;
    const int fl = s.flags[i];
    const bool final_solve = !ROLLOUT || s.tick[i] == a.ticks - 1;
    if (fl & F_RECORD) {
      s.stat[i * 6 + 2] = __int_as_float(s.res[i * 4 + 0]);
      s.stat[i * 6 + 3] = __int_as_float(s.res[i * 4 + 1]) * a.rho;
      s.stat[i * 6 + 4] = __int_as_float(s.res[i * 4 + 2]);
      s.stat[i * 6 + 5] = __int_as_float(s.res[i * 4 + 3]) * a.rho;
      s.res[i * 4 + 0] = 0; s.res[i * 4 + 1] = 0;
      s.res[i * 4 + 2] = 0; s.res[i * 4 + 3] = 0;
    }
    bool frozen = false;
    if (ADAPTIVE && (fl & F_CHECK)) {
      frozen = s.viol[i] == 0;
      s.viol[i] = 0;
    }
    if (frozen) {
      s.stat[i * 6 + 0] = (float)it;
      s.stat[i * 6 + 1] = 1.0f;
      s.done[i] = DONE;
      s.ret[i] = final_solve ? R_RETIRE_EMIT : R_RETIRE;
      s.list[atomicAdd(s.nref, 1)] = i;
    } else {
      s.zpar[i] ^= 1;
      if (it == a.max_iter) {
        s.stat[i * 6 + 0] = (float)a.max_iter;
        s.done[i] = CAPPED;
        s.ret[i] = R_RETIRE;
        s.list[atomicAdd(s.nref, 1)] = i;
      } else {
        s.flags[i] = iteration_flags<ADAPTIVE>(a, it + 1, final_solve);
        live = 1;
      }
    }
  }
  return live;
}

// Backward product: D[i][c] = sum_k S[i][k] Wb[k][c] + const_d[c], const_d
// the slot's row (the tick's row when tracking). A register tile is RI slots
// x TJ adjacent columns; its depth Dz is split over ksplit adjacent lanes
// (k-steps h, h + ksplit, ...), whose partial sums meet in a butterfly of
// shuffles (a fixed order). A lane sums its k-steps in blocks of BWD_BLOCK
// (see there). Frozen slots keep their D.
template <int RI, bool GOPS>
__device__ inline void backward_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const int H = d.ksplit;
  const int ncg = d.DuP / TJ;
  const int nitems = ncg * (d.tile / RI) * H;
  const int nq = d.DzP >> 2;
  for (int base = 0; base < nitems; base += blockDim.x) {
    const int raw = base + threadIdx.x;
    const bool active = raw < nitems;
    const int item = active ? raw : nitems - 1;
    const int h = item & (H - 1);
    const int rest = item / H;
    const int g = rest / ncg, cg = rest - g * ncg;
    const int i0 = g * RI, c0 = cg * TJ;
    bool dn[RI];
    bool live = false;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      dn[r] = !active || s.done[i0 + r] == DONE;
      live |= !dn[r];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform
    float acc[RI][TJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < TJ; ++c) acc[r][c] = 0.0f;
    if (live) {
      const float* Sg = s.S + i0 * d.DzP;
      const float* Wc = s.Wb + c0;
      // FMA chains into dst over the lane's float4 steps q0, q0 + H, ...
      // below q1.
      auto chain = [&](float (&dst)[RI][TJ], int q0, int q1) {
        for (int q = q0; q < q1; q += H) {
          const int k = q << 2;
          float w[4][TJ];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 wv = ldw4<GOPS>(Wc + (k + kk) * d.DuP);
            w[kk][0] = wv.x; w[kk][1] = wv.y; w[kk][2] = wv.z; w[kk][3] = wv.w;
          }
#pragma unroll
          for (int r = 0; r < RI; ++r) {
            const float4 sv =
                *reinterpret_cast<const float4*>(Sg + r * d.DzP + k);
#pragma unroll
            for (int c = 0; c < TJ; ++c) {
              dst[r][c] = fmaf(sv.x, w[0][c], dst[r][c]);
              dst[r][c] = fmaf(sv.y, w[1][c], dst[r][c]);
              dst[r][c] = fmaf(sv.z, w[2][c], dst[r][c]);
              dst[r][c] = fmaf(sv.w, w[3][c], dst[r][c]);
            }
          }
        }
      };
      if (nq <= H * BWD_BLOCK) {
        chain(acc, h, nq);   // at most one block a lane: one chain
      } else {
        // Blocks of BWD_BLOCK (or BWD_FINE) steps, each a fresh chain added
        // to acc.
        const int step =
            H * (RI == 4 && nq > 4 * H * BWD_BLOCK ? BWD_FINE : BWD_BLOCK);
        for (int q0 = h; q0 < nq; q0 += step) {
          float part[RI][TJ];
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c) part[r][c] = 0.0f;
          chain(part, q0, min(nq, q0 + step));
#pragma unroll
          for (int r = 0; r < RI; ++r)
#pragma unroll
            for (int c = 0; c < TJ; ++c)
              acc[r][c] = q0 == h ? part[r][c] : acc[r][c] + part[r][c];
        }
      }
    }
    // The H lanes of a tile are adjacent (item = H * tile + h and the items
    // of a warp start at a multiple of 32), so a butterfly over lane bits
    // below H sums exactly one tile's partial sums.
    for (int off = 1; off < H; off <<= 1) {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < TJ; ++c)
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
    }
    if (active && h == 0) {
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        if (dn[r]) continue;
        const float4 cd =
            *reinterpret_cast<const float4*>(s.cd + (i0 + r) * d.DuP + c0);
        *reinterpret_cast<float4*>(s.D + (i0 + r) * d.DuP + c0) =
            make_float4(acc[r][0] + cd.x, acc[r][1] + cd.y,
                        acc[r][2] + cd.z, acc[r][3] + cd.w);
      }
    }
  }
}

// ------------------------------------------------------- retire and refill --

// Results of retired slot i, by one warp. A slot that froze at a check and
// returns its result (ret == R_RETIRE_EMIT) first writes U and X, the
// pre-projection iterate of that check: Xb + D Wf with the D it kept, summed
// in the forward stage's order, so what that check computed; and the
// residuals of that check, from the old slacks (the buffer zpar points at)
// and the new ones (the other buffer, untouched since). For a mission tick
// then the trace row (pre-projection first-knot control and iteration
// count) and the plant step x+ = A x + B u0 into x0 (and x_final after the
// last tick). For a solve, and for the last tick of a mission, the carry
// (D; duals; the slack buffer zpar points at) and the statistics.
template <bool ROLLOUT, bool GOPS, bool LONG>
__device__ inline void retire_slot(const Args& a, const Smem& s, int i) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int b = s.inst[i];
  const int zstride = d.tile * d.DzP;
  const int zp = s.zpar[i];
  const bool final_solve = !ROLLOUT || s.tick[i] == a.ticks - 1;
  if (s.ret[i] == R_RETIRE_EMIT) {   // warp-uniform
    int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u as int views
    warp_row_product<GOPS, LONG>(s.D + i * d.DuP, d.Du, s.Wf, d.DzP, d.Dz,
                     [&](int j, float acc) {
      const int idx = i * d.DzP + j;
      const float xu = s.Xb[idx] + acc;
      if (j < d.Dx) a.X[(size_t)b * d.Dx + j] = xu;
      else a.U[(size_t)b * d.Du + (j - d.Dx)] = xu;
      const float zo = s.ZV[zp * zstride + idx];
      const float zn = s.ZV[(zp ^ 1) * zstride + idx];
      const int o = j < d.Dx ? 0 : 2;
      mx[o] = max(mx[o], __float_as_int(fabsf(xu - zn)));
      mx[o + 1] = max(mx[o + 1], __float_as_int(fabsf(zo - zn)));
    });
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[q] = __reduce_max_sync(0xffffffffu, mx[q]);
    if (lane == 0) {
      s.stat[i * 6 + 2] = __int_as_float(mx[0]);
      s.stat[i * 6 + 3] = __int_as_float(mx[1]) * a.rho;
      s.stat[i * 6 + 4] = __int_as_float(mx[2]);
      s.stat[i * 6 + 5] = __int_as_float(mx[3]) * a.rho;
    }
    __syncwarp();   // the plant step below reuses the Xb row
  }
  if (ROLLOUT) {
    const int t = s.tick[i];
    for (int c = lane; c < d.nu; c += 32)
      a.us[((size_t)t * a.B + b) * d.nu + c] = s.u0[i * d.nu + c];
    if (lane == 0) a.iters[(size_t)t * a.B + b] = (int)s.stat[i * 6 + 0];
    // Plant step, through the slot's Xb row (recomputed after the step).
    float* xn = s.Xb + i * d.DzP;
    for (int r = lane; r < d.nx; r += 32) {
      float ax = 0.0f, bu = 0.0f;
      for (int k = 0; k < d.nx; ++k)
        ax = fmaf(s.x0[i * d.nx + k], s.A[r * d.nx + k], ax);
      for (int k = 0; k < d.nu; ++k)
        bu = fmaf(s.u0[i * d.nu + k], s.Bm[r * d.nu + k], bu);
      xn[r] = ax + bu;
    }
    __syncwarp();
    for (int r = lane; r < d.nx; r += 32) {
      s.x0[i * d.nx + r] = xn[r];
      if (final_solve) a.x_final[(size_t)b * d.nx + r] = xn[r];
    }
  }
  if (!final_solve) return;
  for (int j = lane; j < d.Dz; j += 32) {
    const int idx = i * d.DzP + j;
    const float yg = s.YG[idx];
    const float zv = s.ZV[zp * zstride + idx];
    if (j < d.Dx) {
      a.G[(size_t)b * d.Dx + j] = yg;
      a.V[(size_t)b * d.Dx + j] = zv;
    } else {
      a.Y[(size_t)b * d.Du + (j - d.Dx)] = yg;
      a.Z[(size_t)b * d.Du + (j - d.Dx)] = zv;
    }
  }
  for (int c = lane; c < d.Du; c += 32)
    a.D[(size_t)b * d.Du + c] = s.D[i * d.DuP + c];
  if (lane < 6) a.stats[(size_t)b * 6 + lane] = s.stat[i * 6 + lane];
}

// Slot i after its claim, by one warp: a new instance (s.inst >= 0 and
// s.itc < 0) loads x0 and its warm-start carry (duals zero in a mission: the
// reference resets them every tick) and its cone rows; a mission slot moving
// to its next tick resets its duals only (D and the slacks warm-start it);
// both clear the solve's bookkeeping and compute Xb. An idle slot (no
// instance left) is marked DONE.
template <bool ADAPTIVE, bool ROLLOUT, bool GOPS>
__device__ inline void load_slot(const Args& a, const Smem& s, int i) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int b = s.inst[i];
  if (b < 0) {
    if (lane == 0) { s.done[i] = DONE; s.ret[i] = R_STAY; }
    return;
  }
  const bool fresh = s.itc[i] < 0;
  __syncwarp();   // every lane has read itc before lane 0 resets it
  const int zstride = d.tile * d.DzP;
  float* yg = s.YG + i * d.DzP;
  float* zv = s.ZV + s.zpar[i] * zstride + i * d.DzP;
  if (fresh) {
    // Every load of a round (128 columns of each input row) before any
    // store, so that a lane's loads are in flight together.
    const int nr = max(d.Dx, d.Du);   // Dx >= nx
    for (int c0 = lane; c0 < nr; c0 += 128) {
      float v[4][6];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + 32 * q;
        const size_t su = (size_t)b * d.Du + c, sx = (size_t)b * d.Dx + c;
        const bool u = c < d.Du, x = c < d.Dx;
        v[q][0] = u ? __ldg(a.D0 + su) : 0.0f;
        v[q][1] = u ? __ldg(a.Z0 + su) : 0.0f;
        v[q][2] = u && !ROLLOUT ? __ldg(a.Y0 + su) : 0.0f;
        v[q][3] = x ? __ldg(a.V0 + sx) : 0.0f;
        v[q][4] = x && !ROLLOUT ? __ldg(a.G0 + sx) : 0.0f;
        v[q][5] = c < d.nx ? __ldg(a.x0 + (size_t)b * d.nx + c) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + 32 * q;
        if (c < d.Du) {
          s.D[i * d.DuP + c] = v[q][0];
          zv[d.Dx + c] = v[q][1];
          yg[d.Dx + c] = v[q][2];
        }
        if (c < d.Dx) { zv[c] = v[q][3]; yg[c] = v[q][4]; }
        if (c < d.nx) s.x0[i * d.nx + c] = v[q][5];
      }
    }
    for (int c = lane; c < d.ncp; c += 32) {
      s.cmu[c * d.tile + i] = a.cone_mu[(size_t)c * a.B + b];
      s.csh[c * d.tile + i] = a.cone_shift[(size_t)c * a.B + b];
    }
  } else {
    for (int j = lane; j < d.Dz; j += 32) yg[j] = 0.0f;  // dual reset
  }
  // The tick's reference constant (tracking streams one row per tick).
  if (fresh || (ROLLOUT && a.tracking)) {
    const float* cd = a.cd + (ROLLOUT && a.tracking ? s.tick[i] * d.Du : 0);
    for (int c = lane; c < d.Du; c += 32) s.cd[i * d.DuP + c] = cd[c];
  }
  if (lane < 6) s.stat[i * 6 + lane] = 0.0f;
  if (lane < 4) s.res[i * 4 + lane] = 0;
  if (lane == 0) {
    const int t = ROLLOUT ? s.tick[i] : 0;
    s.viol[i] = 0;
    s.itc[i] = 0;
    s.flags[i] = iteration_flags<ADAPTIVE>(
        a, 1, !ROLLOUT || t == a.ticks - 1);
    s.ret[i] = R_STAY;
    s.done[i] = LIVE;
  }
  __syncwarp();
  slot_xbub<GOPS>(a, s, i);
}

// The next work of slot i, by lane 0 of the warp that retired it: in a
// mission the same instance's next tick, else the next instance from the
// work counter (none left: the slot idles).
template <bool ROLLOUT>
__device__ inline void claim_slot(const Args& a, const Smem& s, int i,
                                  bool initial) {
  if (!initial && ROLLOUT && s.tick[i] < a.ticks - 1) {
    s.tick[i] += 1;
  } else {
    const int b = atomicAdd(a.counter, 1);
    s.inst[i] = b < a.B ? b : -1;
    s.tick[i] = 0;
    s.itc[i] = -1;   // a new instance
  }
}

// Retire the n slots listed in s.list and refill them, one warp per slot
// (initial = true: claim an instance for every slot; the list holds them
// all). Only the slot's own rows are touched, so a warp goes from retiring
// to loading without a barrier. Ends with a barrier. Returns,
// block-uniformly, the number of LIVE slots afterwards.
template <bool ADAPTIVE, bool ROLLOUT, bool GOPS, bool LONG>
__device__ inline int refill_stage(const Args& a, const Smem& s, int n,
                                   bool initial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int e = warp; e < n; e += nwarps) {
    const int i = s.list[e];
    if (!initial) retire_slot<ROLLOUT, GOPS, LONG>(a, s, i);
    __syncwarp();   // every lane is done with the slot's old state
    if (lane == 0) claim_slot<ROLLOUT>(a, s, i, initial);
    __syncwarp();
    load_slot<ADAPTIVE, ROLLOUT, GOPS>(a, s, i);
  }
  __syncthreads();   // the loads' done flags, before they are counted
  if (threadIdx.x == 0) *s.nref = 0;
  return __syncthreads_count(threadIdx.x < a.d.tile &&
                             s.done[threadIdx.x] == LIVE);
}

// ------------------------------------------------------------- solve loop --

// The whole launch of one block: stage the operators, claim an instance
// for every slot, then iterate until the work counter is exhausted and every
// slot is idle. ADAPTIVE = false: every solve runs max_iter iterations; the
// residuals of the final iteration against the pre-save slacks; solved
// stays 0. ADAPTIVE = true: a check where it > warmup and it % check_every
// == 0; a slot that never converges returns the live values after max_iter
// iterations and the residuals of its last check. ROLLOUT: every instance
// runs a.ticks solves, each from zero duals and the previous tick's D and
// slacks, the plant stepped with the pre-projection first-knot control.
// CONES = true splits the slack stage (forward product and clip, barrier,
// cone_stage, barrier, finish_stage); the frozen slots' U and X
// (retire_slot) need no cone code, since the new slacks they read are the
// projected ones. GOPS: the operators are read from device memory (the
// caller's padded copies) instead of being staged. RI: slots per register
// tile.
template <int RI, bool ADAPTIVE, bool CONES, bool ROLLOUT, bool GOPS>
__device__ inline void run_block(const Args& a, float* base) {
  const Layout L = make_layout(a.d);
  const Smem s = carve<GOPS>(a, base, L);
  stage_block<GOPS>(a, L, base, s);
  __syncthreads();
  if (threadIdx.x < a.d.tile) s.list[threadIdx.x] = threadIdx.x;
  __syncthreads();
  constexpr bool LONG = RI == 4;   // long-depth sums (FWD_CHAIN)
  int live =
      refill_stage<ADAPTIVE, ROLLOUT, GOPS, LONG>(a, s, a.d.tile, true);
  while (live > 0) {
    forward_stage<RI, CONES, ROLLOUT, GOPS>(a, s);
    __syncthreads();
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      finish_stage(a, s);
      __syncthreads();
    }
    // A slot that freezes must be DONE before the backward stage reads the
    // flags; without checks a slot only turns CAPPED, which the backward
    // stage runs like a LIVE one, so no barrier is needed between the two.
    live = decide_stage<ADAPTIVE, ROLLOUT>(a, s);
    if (ADAPTIVE) {
      live = __syncthreads_count(live);
      backward_stage<RI, GOPS>(a, s);
      __syncthreads();
    } else {
      backward_stage<RI, GOPS>(a, s);
      live = __syncthreads_count(live);
    }
    const int nret = *s.nref;   // slots waiting to be retired
    if (nret >= refill_min<RI>() || (live == 0 && nret > 0)) {
      live = refill_stage<ADAPTIVE, ROLLOUT, GOPS, LONG>(a, s, nret, false);
    } else if (threadIdx.x < a.d.tile && s.done[threadIdx.x] == CAPPED) {
      s.done[threadIdx.x] = DONE;   // it waits for a refill; the next
    }                               // forward stage's barrier orders this
  }
}

}  // namespace atm
