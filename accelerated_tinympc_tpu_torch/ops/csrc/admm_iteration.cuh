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
//   * Split-bf16 mode (template parameter SPLIT; replaces the TPU package's
//     algo="bf16x3", ops/fused_admm.py _split_bf16/_dot3/_make_ws): the
//     iterations a slot's schedule names (F_SPLIT) run both products as
//     three bf16 passes (hi.hi + (hi.lo + lo.hi)) on the tensor cores,
//     mma.sync m16n8k16 with float32 accumulators (split_forward,
//     split_backward, split_item). The operator is the A operand (16 of
//     its columns a tile), split once per launch into fragment order in
//     device memory (split_operators_kernel, fused_entry.cuh); 8 slots are
//     the B operand, split in registers from the slot rows. Shared memory:
//     all fragments beside the float32 operators (61,440 B at the
//     flagship) would cut a block from 48 slots to 32, and the float32
//     kernel runs 1.19x slower at 32 (PERF.md). So the forward fragments
//     are read from device memory (resident in L2, prefetched into L1 an
//     item ahead), and on a launch that splits, the backward fragments
//     take the place of the float32 Wb and Wx, which its float32
//     iterations and refills then read from device memory: a split block
//     holds its float32 twin's slots. The products are latency-bound on
//     eight warps, so a warp sums an item of several tiles at once (2 x 2
//     forward, 3 x 1 backward) with no branch between their mma, two
//     k-steps a loop pass. Slots refill independently, so one block
//     iteration holds slots on split and on float32 iterations: a split
//     slot's forward product and elementwise stage are done by the warp
//     that summed it, and forward_stage runs the float32 slots' FFMA code
//     beside it with no barrier between (disjoint rows; a register tile
//     with no float32 row skips its FFMAs); the backward product writes the
//     split slots' D, and backward_stage skips them. Every tile keeps one
//     order of sums (split_item), so the result does not depend on how
//     tiles are grouped into items.
//   * Slacks are double-buffered per slot (zpar) so that the check
//     iteration can read the old slack for the dual residual and still leave
//     it in place for a slot that freezes.
//
//   * Second-order cones (template parameter CONES; replaces the TPU
//     package's _cone_apply, ops/fused_admm.py) couple the ball and axis
//     entries of one knot, which sit in different threads' register tiles:
//     a knot of 6 states or 3 inputs starts anywhere on the float4 grid,
//     and may cross a warp's boundary in the forward stage's dense items.
//     The float32 kernels keep the box-only iteration's barriers all the
//     same (cone_forward_stage): the wrapper lays the columns out per warp
//     pass so that every coned knot lies in one warp (ops/fused_admm.py
//     cone_items; a float4 group cut between knots is computed by both
//     warps, each storing its own columns), and the slack stage runs in
//     that pass: the box clip into the new slack buffer, __syncwarp, the
//     warp projects its knots' slacks, a (knot, slot) pair a lane, each
//     cone in order (exact projection, three cases: cone_project),
//     __syncwarp, then dual ascent, S = slack - dual, the residual terms and
//     the violation flag against the projected slack. The split-bf16
//     kernels, and a knot wider than a warp's 32 column groups, run the
//     stage in three passes with a barrier between (forward_stage<CONES>,
//     cone_stage with a thread per (slot, knot), finish_stage): the same
//     arithmetic in the same order, so the same bits. The box-only
//     instantiations contain no cone code.
//
// Stage order per iteration is the reference's (src/tinympc/admm.cpp:117-150)
// in its folded condensed form: forward (x0 terms hoisted into XbUb), slack
// projection (fminf/fmaxf, safe with infinite bounds), dual ascent, then the
// linear-cost and backward stages as the single product against Wb plus the
// hoisted const_d.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

// Stage hooks for tools/torch_fused_stage_clocks.py (empty here): block
// marks after barriers (ATM_CLK), per-warp spans (ATM_WCLK), per-slot
// retire and load spans (ATM_SCLK).
#ifndef ATM_CLK
#define ATM_CLK_BEGIN() do { } while (0)
#define ATM_CLK_MARK() do { } while (0)
#define ATM_CLK(k) do { } while (0)
#define ATM_CLK_COUNT(k) do { } while (0)
#define ATM_WCLK_BEGIN() do { } while (0)
#define ATM_WCLK(k) do { } while (0)
#define ATM_SCLK_BEGIN() do { } while (0)
#define ATM_SCLK_MID() do { } while (0)
#define ATM_SCLK_END(initial) do { } while (0)
#define ATM_CLK_END() do { } while (0)
#endif

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

// Words of one warp pass of the fused cone pass (cone_forward_stage; the
// wrapper's ops/fused_admm.py RUN_WORDS): 32 items, the counts of its coned
// state and input knots, then those knots (at most 4 start in each of 32
// column groups).
constexpr int RUN_WORDS = 32 + 2 + 128;

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
constexpr int F_SPLIT = 8;   // split-bf16 products (SPLIT kernels only)
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
  int split;        // 1: the split-bf16 kernels (operator fragments, bsp)
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
                                          int ri = 8, int split = 0) {
  Dims d;
  d.nx = nx; d.nu = nu; d.N = N;
  d.Dx = N * nx; d.Du = (N - 1) * nu; d.Dz = d.Dx + d.Du;
  d.DuP = r4(d.Du); d.DzP = r4(d.Dz);
  d.tile = tile;
  d.ksplit = 1;
  d.ncp = ncp;
  d.gops = gops;
  d.ri = ri;
  d.split = split;
  return d;
}

// Split-bf16 operator fragments: the forward product's A operand is Wf^T
// (Dz rows, depth Du), the backward one's Wb^T (Du rows, depth Dz), each in
// tiles of 16 rows x 16 depth. A tile is 256 words: the hi halves of the
// four A registers of lane l at words 4l..4l+3, the lo halves at 128 + 4l
// (one uint4 load per lane for each). Forward tiles first, tile (mt, kt) at
// mt * KT + kt.
__host__ __device__ inline int split_mt_f(const Dims& d) { return (d.Dz + 15) / 16; }
__host__ __device__ inline int split_kt_f(const Dims& d) { return (d.Du + 15) / 16; }
__host__ __device__ inline int split_mt_b(const Dims& d) { return (d.Du + 15) / 16; }
__host__ __device__ inline int split_kt_b(const Dims& d) { return (d.Dz + 15) / 16; }
__host__ __device__ inline int split_words_b(const Dims& d) {
  return 256 * split_mt_b(d) * split_kt_b(d);
}
__host__ __device__ inline int split_words(const Dims& d) {
  return 256 * split_mt_f(d) * split_kt_f(d) + split_words_b(d);
}

// Offsets, in 4-byte words, of every region of the block's dynamic shared
// memory. The Python wrapper mirrors `total` (ops/fused_admm.py,
// kernel_smem_bytes) and the C entry refuses a launch if the two disagree.
struct Layout {
  int Wf, Wb, Wx, lo, hi, A, Bm;               // staged once per block
  int D, cd, S, YG, ZV, Xb, x0, u0, stat;      // per-slot floats
  int res, done, zpar, viol, itc, flags, inst, tick, ret, list, nref;
  int cmu, csh;                                // per-slot cone mu, shift
  int bsp, W3b;                                // split-bf16 kernels only
  int total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = 0;
  const int t = d.tile;
  const int staged = d.gops ? 0 : 1;  // operators in shared memory
  // A split launch stages the backward operator's fragments in place of
  // Wb and Wx, which it reads from device memory (backward_stage, carve).
  const int staged_b = staged && !d.split;
  L.Wf = o;   o += staged * d.DuP * d.DzP;  // k rows; past Du, Dz zero
  L.Wb = o;   o += staged_b * d.DzP * d.DuP;
  L.Wx = o;   o += staged_b * d.nx * d.DzP;
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
  // Split-bf16 kernels: each slot's split flag of its running iteration,
  // and (operators staged) the backward operator's fragments; the forward
  // operator's fragments stay in device memory.
  L.bsp = o;  o += d.split * t;
  L.W3b = o;  o += d.split * staged * split_words_b(d);
  L.total = o;
  return L;
}

// Everything a kernel needs; filled by the C entries in fused_admm.cu.
struct Args {
  // inputs, (B, .) row-major, unpadded
  const float *x0, *D0, *Y0, *G0, *Z0, *V0;
  // operators and vectors shared by the batch
  const float *Wf, *Wb, *Wx;    // (DuP,DzP), (DzP,DuP), (nx,DzP), zero padded
  uint32_t* W3;                 // split-bf16 operator fragments (split_words)
  const float *cd;              // (Du) const_d, or (ticks,Du) when tracking
  const float *lo, *hi;         // (Dz) bounds over z = [x | u]
  const float *A, *Bm;          // plant (nx,nx), (nx,nu); rollout only
  // cones (coned kernels only): the table, and per-instance mu/shift rows
  // (nc,B) over all cones in the table's order, or nullptr for the static
  // values
  ConeTable cones;
  const float *cone_mu, *cone_shift;
  // coned float32 kernels: the fused cone pass's runs (cone_chunks of
  // RUN_WORDS, one per warp pass; see cone_forward_stage), or nullptr for
  // the three coned passes
  const int* cone_items;
  int cone_chunks;
  // outputs
  float *U, *X, *D, *Y, *G, *Z, *V, *stats;   // stats (B,6)
  float *us;                    // (ticks,B,nu)  rollout only
  int *iters;                   // (ticks,B)     rollout only
  float *x_final;               // (B,nx)        rollout only
  int *counter;                 // work counter, 0 at launch
  int B, ticks, tracking;
  int max_iter, check_every, warmup;
  int n3;                       // split-bf16, fixed: iterations 1..n3 split
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
  const uint4 *W3f, *W3b;      // split operator fragments (forward, backward)
  const float* Wbg;            // Wb in device memory (the split kernels)
  int* bsp;                    // split flag of each slot's running iteration
};

template <bool GOPS, bool SPLIT>
__device__ inline Smem carve(const Args& a, float* base, const Layout& L) {
  Smem s;
  auto I = [base](int off) { return reinterpret_cast<int*>(base + off); };
  if (GOPS) {
    s.Wf = a.Wf; s.Wb = a.Wb; s.Wx = a.Wx;
  } else {
    s.Wf = base + L.Wf; s.Wb = base + L.Wb; s.Wx = base + L.Wx;
    // a split launch reads Wx (refills only) and Wb (s.Wbg) from device
    // memory: make_layout stages Wb's fragments in their place
    if constexpr (SPLIT) {
      if (a.d.split) s.Wx = a.Wx;
    }
  }
  s.Wbg = a.Wb;
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
  s.W3f = s.W3b = nullptr;
  if (a.d.split) {
    const uint4* w3 = reinterpret_cast<const uint4*>(a.W3);
    s.W3f = w3;
    s.W3b = GOPS ? w3 + 64 * split_mt_f(a.d) * split_kt_f(a.d)
                 : reinterpret_cast<const uint4*>(base + L.W3b);
  }
  s.bsp = I(L.bsp);
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
template <bool GOPS, bool SPLIT>
__device__ inline void stage_block(const Args& a, const Layout& L,
                                   float* base, const Smem& s) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L.total; i += nt) base[i] = 0.0f;
  __syncthreads();
  if (!GOPS) {
    for (int i = tid; i < d.DuP * d.DzP; i += nt) base[L.Wf + i] = a.Wf[i];
    if (SPLIT && d.split) {
      const uint4* src = reinterpret_cast<const uint4*>(a.W3) +
                         64 * split_mt_f(d) * split_kt_f(d);
      uint4* dst = reinterpret_cast<uint4*>(base + L.W3b);
      for (int i = tid; i < split_words_b(d) / 4; i += nt) dst[i] = src[i];
    } else {
      for (int i = tid; i < d.DzP * d.DuP; i += nt) base[L.Wb + i] = a.Wb[i];
      for (int i = tid; i < d.nx * d.DzP; i += nt) base[L.Wx + i] = a.Wx[i];
    }
  }
  for (int i = tid; i < d.Dz; i += nt) { s.lo[i] = a.lo[i]; s.hi[i] = a.hi[i]; }
  if (a.A != nullptr) {
    for (int i = tid; i < d.nx * d.nx; i += nt) s.A[i] = a.A[i];
    for (int i = tid; i < d.nx * d.nu; i += nt) s.Bm[i] = a.Bm[i];
  }
}

// Flags of a slot's iteration `it` (1-based). final_solve: the slot's
// result is returned (every solve; the last tick of a mission). Split-bf16
// kernels: the TPU package's schedules (_fixed_core, _adaptive_core): a
// fixed solve splits its first n3 = max_iter - max(1, polish) iterations,
// an adaptive one every iteration but the checks past the warmup and the
// one at the cap (so every check, and every result, is a float32 one).
template <bool ADAPTIVE>
__device__ inline int iteration_flags(const Args& a, int it, bool final_solve) {
  const bool last = it == a.max_iter;
  const bool check = ADAPTIVE && it > a.warmup && it % a.check_every == 0;
  const bool record =
      ADAPTIVE ? check && it == (a.max_iter / a.check_every) * a.check_every
               : last;
  const bool split =
      a.d.split &&
      (ADAPTIVE ? !(it > a.warmup && (it % a.check_every == 0 || last))
                : it <= a.n3);
  return (check ? F_CHECK : 0) | (record ? F_RECORD : 0) |
         (last && final_solve ? F_EMIT : 0) | (split ? F_SPLIT : 0);
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

// ------------------------------------------------ split-bf16 products --

// (x0, x1) as bf16 pairs: hi = bf16(x) (round to nearest even), lo = bf16(x
// - hi) (x - hi is exact in float32), x0 in the low half of each word, as
// an mma fragment register holds a pair of adjacent depth entries.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += A B for one m16n8k16 tile: A (16 x 16 bf16, row) in four registers,
// B (16 x 8 bf16, col) in two, c float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Running sums of one warp's item of MR x NR tiles (split_item).
template <int MR, int NR>
struct SplitAcc {
  float hh[MR][NR][4], cr[MR][NR][4];
};

// P[i][m] = sum_{k < K} x[i][k] Op[k][m] in three bf16 passes, for the item
// of MR x NR m16n8k16 tiles whose first operator tile (16 columns m) is m0
// and whose first group of 8 slots i is n0. The operator is the A operand,
// from its fragments (split_words: tile (mt, kt) at 64 uint4, hi halves at
// lane, lo halves at 32 + lane), in device memory (GFRAG; they stay in L2)
// or in shared memory; the slots are the B operand, split here from float2
// loads of their rows (ldx floats apart, zero beyond K up to ldx). Bit u of
// mmask: tile m0 + u exists; bit j of nmask: group n0 + j holds a selected
// slot (both warp-uniform).
//
// Every k-step feeds MR x NR x 3 independent mma from MR A and NR B
// fragments and loads the next k-step's A fragments first, two k-steps a
// loop pass so that one k-step's mma overlap the next one's loads and
// splits. Every tile of the item runs, with no branch between the mma (a
// missing operator tile repeats tile m0, a group without a selected slot
// sums zeros; neither is stored): a branch per tile kept the compiler from
// overlapping the tiles' mma. (Measured slower, PERF.md: one k-step a pass;
// the operator split in registers from its float32 copy every iteration.)
//
// Each tile keeps the order of sums of a single tile: per k-step hh = xh Oh
// and, into a second fresh accumulator, Oh xl then Ol xh (the TPU package's
// _dot3 grouping; lo lo dropped), each added to its running sum by float32
// adds (the tensor cores' accumulation rounds toward zero, and a running
// sum kept inside them drifted further from float64 than the plain
// versions' float32 sums: PERF.md); P = hh + cr at the end.
template <int MR, int NR, bool GFRAG>
__device__ __forceinline__ void split_item(
    const float* x, int ldx, int K, int KT, const uint4* frag, int m0,
    int n0, int tile, unsigned mmask, unsigned nmask,
    SplitAcc<MR, NR>& acc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* xr[NR];
  bool in[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int slot = (n0 + j) * 8 + g;
    in[j] = ((nmask >> j) & 1u) && slot < tile;
    xr[j] = x + (size_t)(in[j] ? slot : 0) * ldx;
  }
#pragma unroll
  for (int u = 0; u < MR; ++u)
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.hh[u][j][q] = acc.cr[u][j][q] = 0.0f;
  auto load_a = [&](uint4 (&h)[MR], uint4 (&l)[MR], int kt) {
#pragma unroll
    for (int u = 0; u < MR; ++u) {
      const int mt = (mmask >> u) & 1u ? m0 + u : m0;
      const uint4* f = frag + ((size_t)mt * KT + kt) * 64;
      h[u] = GFRAG ? __ldg(f + lane) : f[lane];
      l[u] = GFRAG ? __ldg(f + 32 + lane) : f[32 + lane];
    }
  };
  uint4 ah[MR], al[MR], nh[MR], nl[MR];
  load_a(ah, al, 0);
#pragma unroll 2
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_a(nh, nl, kt + 1);
    uint32_t bh0[NR], bl0[NR], bh1[NR], bl1[NR];
    const int k0 = kt * 16 + 2 * t;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const float2 z = make_float2(0.0f, 0.0f);
      const float2 v0 = in[j] && k0 < K
          ? *reinterpret_cast<const float2*>(xr[j] + k0) : z;
      const float2 v1 = in[j] && k0 + 8 < K
          ? *reinterpret_cast<const float2*>(xr[j] + k0 + 8) : z;
      split_pair(v0.x, v0.y, bh0[j], bl0[j]);
      split_pair(v1.x, v1.y, bh1[j], bl1[j]);
    }
#pragma unroll
    for (int u = 0; u < MR; ++u) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        float ph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(ph, ah[u], bh0[j], bh1[j]);
        mma_bf16(pc, ah[u], bl0[j], bl1[j]);
        mma_bf16(pc, al[u], bh0[j], bh1[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc.hh[u][j][q] += ph[q];
          acc.cr[u][j][q] += pc[q];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MR; ++u) {
      ah[u] = nh[u];
      al[u] = nl[u];
    }
  }
}

// The split iterations' elementwise stage of slot i, columns j0..j0+3: the
// forward_stage arithmetic of an iteration without flags (a split iteration
// is never a check, a recording iteration or the last), on the product P
// that split_forward left in S.
template <bool CONES, bool KEEP_U0>
__device__ __forceinline__ void split_finish(const Args& a, const Smem& s,
                                             int i, int j0) {
  const Dims& d = a.d;
  const int zstride = d.tile * d.DzP;
  const float alpha = a.alpha;
  const bool relax = alpha != 1.0f;
  const int idx = i * d.DzP + j0;
  const int zp = s.zpar[i];
  const float4 p4 = *reinterpret_cast<const float4*>(s.S + idx);
  const float4 xb4 = *reinterpret_cast<const float4*>(s.Xb + idx);
  const float4 y4 = *reinterpret_cast<const float4*>(s.YG + idx);
  const float4 z4 =
      *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
  const float4 l4 = *reinterpret_cast<const float4*>(s.lo + j0);
  const float4 h4 = *reinterpret_cast<const float4*>(s.hi + j0);
  const float p[TJ] = {p4.x, p4.y, p4.z, p4.w};
  const float xb[TJ] = {xb4.x, xb4.y, xb4.z, xb4.w};
  const float yo[TJ] = {y4.x, y4.y, y4.z, y4.w};
  const float zo[TJ] = {z4.x, z4.y, z4.z, z4.w};
  const float lo[TJ] = {l4.x, l4.y, l4.z, l4.w};
  const float hi[TJ] = {h4.x, h4.y, h4.z, h4.w};
  float o1[TJ], zn[TJ], o3[TJ];
#pragma unroll
  for (int c = 0; c < TJ; ++c) {
    const int j = j0 + c;
    const float xu = xb[c] + p[c];   // pre-projection X or U
    const float xr = relax ? alpha * xu + (1.0f - alpha) * zo[c] : xu;
    const float tv = xr + yo[c];
    zn[c] = fminf(fmaxf(tv, lo[c]), hi[c]);  // box clip, inf-safe
    if (CONES) {
      o1[c] = tv;             // relaxed iterate + old dual
      o3[c] = xu;             // pre-projection iterate
    } else {
      o1[c] = tv - zn[c];     // dual ascent
      o3[c] = zn[c] - o1[c];  // S = slack - dual
    }
    if (KEEP_U0 && j >= d.Dx && j < d.Dx + d.nu)
      s.u0[i * d.nu + (j - d.Dx)] = xu;
  }
  *reinterpret_cast<float4*>(s.YG + idx) =
      make_float4(o1[0], o1[1], o1[2], o1[3]);
  *reinterpret_cast<float4*>(s.ZV + (zp ^ 1) * zstride + idx) =
      make_float4(zn[0], zn[1], zn[2], zn[3]);
  *reinterpret_cast<float4*>(s.S + idx) =
      make_float4(o3[0], o3[1], o3[2], o3[3]);
}

// Tiles per warp item: the forward product (Dz operator columns, depth Du)
// in items of 2 operator tiles x 2 slot groups, the backward one (Du
// columns, depth Dz) in items of 3 x 1. At the flagship with 48 slots the
// forward's 60 tiles make 15 items and the backward's 18 make 6 items of
// its 3 operator tiles (one B fragment feeds 3 tiles; a tile's sums stay in
// k order in one warp, so the depth is not split over warps).
constexpr int SPLIT_FWD_MR = 2, SPLIT_FWD_NR = 2;
constexpr int SPLIT_BWD_MR = 3, SPLIT_BWD_NR = 1;

// Brings the device-memory fragments of the first k-steps (at most 2) of
// operator tiles m0 .. m0 + MR - 1 (those below MT) into L1, so that
// split_item's first loads of an item wait on L1, not L2.
template <int MR>
__device__ __forceinline__ void prefetch_frags(const uint4* frag, int m0,
                                               int MT, int KT) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < MR; ++u)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      if (m0 + u >= MT || kt >= KT) continue;
      const uint4* f = frag + ((size_t)(m0 + u) * KT + kt) * 64;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(f + lane));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(f + 32 + lane));
    }
}

// The items of one split product, MR operator tiles by NR slot groups, for
// this warp: item(m0, n0, mmask, nmask, next_m0) for each that holds a
// selected slot (sel), in turn over the warps; next_m0 is the first operator
// tile of the warp's next item (-1 for none).
template <int MR, int NR, typename Sel, typename Item>
__device__ __forceinline__ void split_items(int MT, int tile, Sel&& sel,
                                            Item&& item) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int NT = (tile + 7) >> 3;
  const int CM = (MT + MR - 1) / MR, CN = (NT + NR - 1) / NR;
#pragma unroll 1
  for (int it = warp; it < CM * CN; it += nwarps) {
    const int cn = it / CM, cm = it - cn * CM;
    const int m0 = cm * MR, n0 = cn * NR;
    const int next = it + nwarps;
    const int next_m0 = next < CM * CN ? (next % CM) * MR : -1;
    unsigned mmask = 0u, nmask = 0u;
#pragma unroll
    for (int u = 0; u < MR; ++u) mmask |= (m0 + u < MT ? 1u : 0u) << u;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int slot = (n0 + j) * 8 + (lane >> 2);
      nmask |= (__any_sync(0xffffffffu, slot < tile && sel(slot)) ? 1u : 0u)
               << j;
    }
    if (nmask != 0u) item(m0, n0, mmask, nmask, next_m0);   // warp-uniform
  }
}

// The split iterations' forward stage: the slots on a split iteration get
// their forward product here, and their elementwise stage from the warp
// that summed it (split_finish), so no barrier stands between this and
// forward_stage, which runs the other slots (the two touch disjoint rows).
// A warp writes each tile's products into the tile's S entries, then,
// after a __syncwarp, runs the elementwise stage of the item's rows, a
// float4 a lane. Also each slot's split flag for the backward stage (bsp:
// decide_stage has moved the flags on to the next iteration by then).
template <bool CONES, bool KEEP_U0>
__device__ inline void split_forward(const Args& a, const Smem& s) {
  constexpr int MR = SPLIT_FWD_MR, NR = SPLIT_FWD_NR;
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto sel = [&](int i) {
    return s.done[i] == LIVE && (s.flags[i] & F_SPLIT) != 0;
  };
  if (threadIdx.x < d.tile) s.bsp[threadIdx.x] = sel(threadIdx.x);
  const int KT = split_kt_f(d), MT = split_mt_f(d);
  const int warp = threadIdx.x >> 5;
  if (warp < (MT + MR - 1) / MR * ((d.tile + 8 * NR - 1) / (8 * NR)))
    prefetch_frags<MR>(s.W3f, warp % ((MT + MR - 1) / MR) * MR, MT, KT);
  split_items<MR, NR>(MT, d.tile, sel, [&](int m0, int n0, unsigned mmask,
                                           unsigned nmask, int next_m0) {
    SplitAcc<MR, NR> acc;
    split_item<MR, NR, true>(s.D, d.DuP, d.Du, KT, s.W3f, m0, n0, d.tile,
                             mmask, nmask, acc);
    if (next_m0 >= 0) prefetch_frags<MR>(s.W3f, next_m0, MT, KT);
    ATM_WCLK(10);
    // c0, c1: operator column 16 mt + g, slots 8 nt + 2t, 2t + 1; c2, c3:
    // column + 8. Whether each of the lane's slots takes its result is read
    // once, so that the stores need no branch.
    bool so[NR][2];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = (n0 + j) * 8 + 2 * t + c;
        so[j][c] = ((nmask >> j) & 1u) && i < d.tile && sel(i);
      }
#pragma unroll
    for (int u = 0; u < MR; ++u)
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = (n0 + j) * 8 + 2 * t + (q & 1);
          const int m = (m0 + u) * 16 + g + (q >= 2 ? 8 : 0);
          if (so[j][q & 1] && ((mmask >> u) & 1u) && m < d.DzP)
            s.S[i * d.DzP + m] = acc.hh[u][j][q] + acc.cr[u][j][q];
        }
    __syncwarp();
    // The item's rows of MR x 16 adjacent columns: 8 lanes a row of MR x 4
    // float4, so that each quarter warp reads and writes one contiguous run
    // (no bank conflicts); two runs a lane at once.
    constexpr int F = MR * 4, P = NR * 8 * F / 32;
    static_assert(NR * 8 * F % 32 == 0, "whole passes of the warp");
    bool sp[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int row = (p * 32 + lane) / F, c4 = (p * 32 + lane) % F;
      const int i = (n0 + (row >> 3)) * 8 + (row & 7);
      sp[p] = ((mmask >> (c4 >> 2)) & (nmask >> (row >> 3)) & 1u) &&
              i < d.tile && m0 * 16 + 4 * c4 < d.DzP && sel(i);
    }
#pragma unroll 2
    for (int p = 0; p < P; ++p) {
      const int row = (p * 32 + lane) / F, c4 = (p * 32 + lane) % F;
      if (sp[p])
        split_finish<CONES, KEEP_U0>(
            a, s, (n0 + (row >> 3)) * 8 + (row & 7), m0 * 16 + 4 * c4);
    }
    ATM_WCLK(14);
  });
}

// The backward product of the slots on a split iteration: D = S Wb +
// const_d (a split iteration is never a check or the cap, so such a slot
// is live). backward_stage<..., true> skips these rows. Wb's fragments are
// in shared memory unless the operators are read from device memory.
template <bool GOPS>
__device__ inline void split_backward(const Args& a, const Smem& s) {
  constexpr int MR = SPLIT_BWD_MR, NR = SPLIT_BWD_NR;
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto sel = [&](int i) { return s.bsp[i] != 0; };
  const int KT = split_kt_b(d);
  split_items<MR, NR>(split_mt_b(d), d.tile, sel, [&](int m0, int n0,
                                                     unsigned mmask,
                                                     unsigned nmask, int) {
    SplitAcc<MR, NR> acc;
    split_item<MR, NR, GOPS>(s.S, d.DzP, d.Dz, KT, s.W3b, m0, n0, d.tile,
                             mmask, nmask, acc);
    bool so[NR][2];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = (n0 + j) * 8 + 2 * t + c;
        so[j][c] = ((nmask >> j) & 1u) && i < d.tile && sel(i);
      }
#pragma unroll
    for (int u = 0; u < MR; ++u)
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = (n0 + j) * 8 + 2 * t + (q & 1);
          const int m = (m0 + u) * 16 + g + (q >= 2 ? 8 : 0);
          if (so[j][q & 1] && ((mmask >> u) & 1u) && m < d.DuP)
            s.D[i * d.DuP + m] = acc.hh[u][j][q] + acc.cr[u][j][q] +
                                 s.cd[i * d.DuP + m];
        }
  });
}

// ----------------------------------------------------------------- stages --

// The forward product of one register tile: acc[r][c] = sum_k D[i0 + r][k]
// Wf[k][j0 + c] over the padded depth (zeros where no row is live). KDU,
// KDZ (K1's own body, fixed_waves.cuh): DuP and DzP known at compile
// time, so the 8-slot chain unrolls with immediate offsets (the same sums).
template <int RI, bool GOPS, int KDU = 0, int KDZ = 0>
__device__ __forceinline__ void forward_product(const Dims& d, const Smem& s,
                                                int i0, int j0, bool live,
                                                float (&acc)[RI][TJ]) {
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
    } else {
      // One chain over the depth, a float4 step k at a time (ldd, ldw: the
      // row strides of D and Wf); all steps unrolled where KDU, KDZ are
      // known.
      auto step = [&](int k, int ldd, int ldw) {
        float w[4][TJ];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv = ldw4<GOPS>(Wc + (k + kk) * ldw);
          w[kk][0] = wv.x; w[kk][1] = wv.y; w[kk][2] = wv.z; w[kk][3] = wv.w;
        }
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const float4 dv = *reinterpret_cast<const float4*>(Dg + r * ldd + k);
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            acc[r][c] = fmaf(dv.x, w[0][c], acc[r][c]);
            acc[r][c] = fmaf(dv.y, w[1][c], acc[r][c]);
            acc[r][c] = fmaf(dv.z, w[2][c], acc[r][c]);
            acc[r][c] = fmaf(dv.w, w[3][c], acc[r][c]);
          }
        }
      };
      if constexpr (KDU > 0) {
#pragma unroll
        for (int k = 0; k < KDU; k += 4) step(k, KDU, KDZ);
      } else {
        for (int k = 0; k < d.DuP; k += 4) step(k, d.DuP, d.DzP);
      }
    }
  }
}

// Forward product fused with slack projection, dual ascent and residuals.
// A thread owns one (group of RI slots, group of TJ adjacent columns of z)
// register tile at a time. The loop over items is warp-uniform so that the
// residual maxima can reduce with one redux per quantity over the lanes
// that share a slot group. Per slot row, its flags say whether this
// iteration checks (s.viol: raised for a slot with a residual term at or
// above its tolerance), records the four residual maxima or writes U, X to
// device memory. KEEP_U0 (rollout): every iteration leaves the first-knot
// controls in s.u0.
// CONES = true (the three coned passes): the stage ends after the box clip;
// it leaves the pre-projection iterate in S (and in u0, U, X where asked),
// t = relaxed iterate + old dual in YG and the clipped slack in the new
// slack buffer, for cone_stage and finish_stage.
// SPLIT: the rows of slots on a split iteration are split_forward's
// (product and elementwise stage); a register tile with no float32 row
// skips its FFMAs.
template <int RI, bool CONES, bool KEEP_U0, bool GOPS, bool SPLIT = false>
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
      if constexpr (SPLIT) {   // a split row has no other flag
        dn[r] |= (fl[r] & F_SPLIT) != 0;
        fl[r] = dn[r] ? 0 : fl[r];
      }
      live |= !dn[r];
      anyfl |= fl[r];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform
    float acc[RI][TJ];
    forward_product<RI, GOPS>(d, s, i0, j0, live, acc);
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

// The exact projection of (v, sv) onto the cone ||v|| <= mu sv, given
// a2 = ||v||^2 summed by fmaf over the ball in table order and sv = w[axis]
// + shift: returns (scale, s_new), v *= scale, sv = s_new. Inside ->
// unchanged, polar -> 0, else the boundary point; a == 0 guarded. Both
// cone passes (cone_stage, project_run) take it, so they give the same
// bits (tools/torch_fused_bits.py holds both to the three-pass kernels of
// earlier checkouts, chip_smoke.py and tests/test_torch_gpu.py to each
// other).
__device__ __forceinline__ float2 cone_project(float a2, float sv, float mu) {
  const float an = sqrtf(a2);
  const bool inside = an <= mu * sv;
  const bool polar = mu * an <= -sv;
  const float cc = (mu * an + sv) / (mu * mu + 1.0f);
  const float safe_a = a2 == 0.0f ? 1.0f : an;
  return make_float2(polar ? 0.0f : (inside ? 1.0f : mu * cc / safe_a),
                     inside ? sv : (polar ? 0.0f : cc));
}

// The second of the three coned passes (the split-bf16 kernels, and knots
// wider than a warp's items; cone_forward_stage does it in the forward
// stage otherwise): cone projections, one thread per (slot, knot), knots
// 0..N-1 the state knots, N..2N-2 the input knots. forward_stage<true> has
// left the box-clipped slack in the new slack buffer; each cone of the
// knot's kind is applied to it in order, in place (cone_project). mu and
// shift come from the per-slot rows when given (d.ncp > 0), else from the
// table: the arithmetic is the same either way. The table is read from
// device memory (a few hundred bytes that stay in L1).
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
      const float2 ss = cone_project(a2, zn[axis] + shift, mu);
      for (int b = 0; b < nball; ++b) zn[__ldg(ball + b)] *= ss.x;
      zn[axis] = ss.y - shift;
    }
  }
}

// The last of the three coned passes (see cone_stage) closes the coned
// slack stage, one thread per (slot, group of TJ columns):
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

// The cones of one warp pass's knots (run: see cone_forward_stage), in
// place in the new slack buffers, by the whole warp: the (knot, slot)
// pairs of each kind, state knots first, a pair a lane, CONE_BATCH pairs of
// a lane at once. Per cone, in table order, a lane loads its pairs' ball
// and axis entries before it stores any, so that their loads are in flight
// together, then projects them (cone_project); a ball scaled by 1 is not
// stored again (x * 1 is x). Live slots only. The arithmetic of each
// (slot, knot) is cone_stage's, in the same order.
constexpr int CONE_BATCH = 4;

template <int RI>
__device__ __forceinline__ void project_run(const Args& a, const Smem& s,
                                            const int* run) {
  const Dims& d = a.d;
  const ConeTable& ct = a.cones;
  const int lane = threadIdx.x & 31;
  const int zstride = d.tile * d.DzP;
  const int kx = __ldg(run + 32), ku = __ldg(run + 33);
  for (int kind = 0; kind < 2; ++kind) {   // state knots, then input knots
    const int np = (kind ? ku : kx) * RI;
    const int* knots = run + 34 + (kind ? kx : 0);
    const int c0 = kind ? 0 : ct.nc_u;
    const int c1 = kind ? ct.nc_u : ct.nc_u + ct.nc_x;
    // pair p: slot p % RI of knot p / RI; its slacks' row and the knot's
    // first column, or nullptr for no live slot
    auto pair = [&](int p, int& i) -> float* {
      if (p >= np) return nullptr;
      const int e = __ldg(knots + p / RI);
      i = (e >> 16) * RI + p % RI;
      if (s.done[i] != LIVE) return nullptr;
      return s.ZV + (s.zpar[i] ^ 1) * zstride + i * d.DzP + (e & 0xffff);
    };
    for (int p0 = 0; p0 < np; p0 += 32 * CONE_BATCH) {
      float* z[CONE_BATCH];
      int slot[CONE_BATCH] = {};
#pragma unroll
      for (int j = 0; j < CONE_BATCH; ++j)
        z[j] = pair(p0 + lane + 32 * j, slot[j]);
      for (int q = c0; q < c1; ++q) {
        const int* row = ct.idx + __ldg(ct.idx + q);
        const int nball = __ldg(row), axis = __ldg(row + 1);
        const int* ball = row + 2;
        auto mu_of = [&](int i) {
          return d.ncp ? s.cmu[q * d.tile + i] : __ldg(ct.par + 2 * q);
        };
        auto shift_of = [&](int i) {
          return d.ncp ? s.csh[q * d.tile + i] : __ldg(ct.par + 2 * q + 1);
        };
        float a2[CONE_BATCH];
#pragma unroll
        for (int j = 0; j < CONE_BATCH; ++j) a2[j] = 0.0f;
        for (int b = 0; b < nball; ++b) {
          const int o = __ldg(ball + b);
#pragma unroll
          for (int j = 0; j < CONE_BATCH; ++j)
            if (z[j] != nullptr) {
              const float v = z[j][o];
              a2[j] = fmaf(v, v, a2[j]);
            }
        }
        float2 ss[CONE_BATCH];
        float shift[CONE_BATCH];
#pragma unroll
        for (int j = 0; j < CONE_BATCH; ++j) {
          if (z[j] == nullptr) continue;
          shift[j] = shift_of(slot[j]);
          ss[j] = cone_project(a2[j], z[j][axis] + shift[j], mu_of(slot[j]));
        }
        for (int b = 0; b < nball; ++b) {
          const int o = __ldg(ball + b);
#pragma unroll
          for (int j = 0; j < CONE_BATCH; ++j)
            if (z[j] != nullptr && ss[j].x != 1.0f) z[j][o] *= ss[j].x;
        }
#pragma unroll
        for (int j = 0; j < CONE_BATCH; ++j)
          if (z[j] != nullptr) z[j][axis] = ss[j].y - shift[j];
      }
    }
  }
}

// Stores the columns c of v with bit c of own set (all four: one float4).
__device__ __forceinline__ void store_owned(float* p, const float (&v)[TJ],
                                            int own) {
  if (own == 15) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < TJ; ++c)
    if ((own >> c) & 1) p[c] = v[c];
}

// The coned slack stage in one pass with the forward product, by warps
// (the coned float32 kernels; the split-bf16 ones run the three passes).
// The wrapper (ops/fused_admm.py cone_items) lays every slot group's
// columns out in runs of 32 items, one run a warp pass (a.cone_items, runs
// of RUN_WORDS; -1 pads a run), cut only between knots of a coned kind, so
// that every such knot lies in one warp; after its items a run lists its
// coned knots. An item is a register tile (slot group g, column group cg)
// with the columns it owns (a group cut inside is computed by both warps,
// each storing its own columns). Per item: the product, the box clip into
// the new slack buffer; __syncwarp; the warp projects its knots
// (project_run); __syncwarp; dual ascent against the projected slack, S =
// slack - dual, the residual terms, the violation flag and the recorded
// maxima, as finish_stage does, with t = relaxed
// iterate + old dual still in registers (the iterate waits in S where the
// warp checks or records). So a coned iteration has the box-only
// iteration's barriers. Each element's arithmetic is that of
// forward_stage<CONES = true>, cone_stage and finish_stage, in the same
// order: both paths give the same bits. The clip and the dual ascent run in
// versions by the flags of the warp's slots, the cones in one.
template <int RI, bool KEEP_U0, bool GOPS>
__device__ inline void cone_forward_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int zstride = d.tile * d.DzP;
  const float alpha = a.alpha;
  const bool relax = alpha != 1.0f;
  for (int ch = warp; ch < a.cone_chunks; ch += nwarps) {
    const int* run = a.cone_items + ch * RUN_WORDS;
    const int code = __ldg(run + lane);
    const bool active = code >= 0;
    const int own = active ? code & 15 : 0;
    const int g = active ? code >> 20 : 0;
    const int i0 = g * RI, j0 = (active ? (code >> 8) & 0xfff : 0) * TJ;
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
    forward_product<RI, GOPS>(d, s, i0, j0, live, acc);
    const float4 l4 = *reinterpret_cast<const float4*>(s.lo + j0);
    const float4 h4 = *reinterpret_cast<const float4*>(s.hi + j0);
    const float lo[TJ] = {l4.x, l4.y, l4.z, l4.w};
    const float hi[TJ] = {h4.x, h4.y, h4.z, h4.w};
    const bool holds_u0 = j0 < d.Dx + d.nu && j0 + TJ > d.Dx;
    const unsigned wfl = __reduce_or_sync(0xffffffffu, (unsigned)anyfl);
    // t = relaxed iterate + old dual, from the clip to the dual ascent
    float tv[RI][TJ];
    // The box clip into the new slack buffer (owned columns). FLAGS: some
    // slot of the warp checks, records or emits; the iterate then waits in
    // S for the residual terms.
    auto clip = [&](auto flags_tag) {
      constexpr bool FLAGS = decltype(flags_tag)::value;
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        if (dn[r]) continue;
        const int i = i0 + r;
        const int idx = i * d.DzP + j0;
        const int zp = s.zpar[i];
        const float4 xb4 = *reinterpret_cast<const float4*>(s.Xb + idx);
        const float4 y4 = *reinterpret_cast<const float4*>(s.YG + idx);
        const float4 z4 =
            *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
        const float xb[TJ] = {xb4.x, xb4.y, xb4.z, xb4.w};
        const float yo[TJ] = {y4.x, y4.y, y4.z, y4.w};
        const float zo[TJ] = {z4.x, z4.y, z4.z, z4.w};
        float xu[TJ], zn[TJ];
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
          const int j = j0 + c;
          const bool mine = (own >> c) & 1;
          xu[c] = xb[c] + acc[r][c];   // pre-projection X or U
          const float xr = relax ? alpha * xu[c] + (1.0f - alpha) * zo[c] : xu[c];
          tv[r][c] = xr + yo[c];
          zn[c] = fminf(fmaxf(tv[r][c], lo[c]), hi[c]);  // box clip
          if (KEEP_U0 && holds_u0 && mine && j >= d.Dx && j < d.Dx + d.nu)
            s.u0[i * d.nu + (j - d.Dx)] = xu[c];
          if (FLAGS && mine && j < d.Dz && (fl[r] & F_EMIT)) {
            const int b = s.inst[i];
            if (j < d.Dx) a.X[(size_t)b * d.Dx + j] = xu[c];
            else a.U[(size_t)b * d.Du + (j - d.Dx)] = xu[c];
          }
        }
        store_owned(s.ZV + (zp ^ 1) * zstride + idx, zn, own);
        if (FLAGS) store_owned(s.S + idx, xu, own);
      }
    };
    if (wfl == 0u) clip(std::false_type{});
    else clip(std::true_type{});
    __syncwarp();   // the warp's clipped slacks, before its cones
    ATM_WCLK(11);
    project_run<RI>(a, s, run);
    __syncwarp();   // the projected slacks
    ATM_WCLK(16);
    // Dual ascent against the projected slack, S = slack - dual and the
    // residual terms, in three versions by the flags of the warp's slots,
    // as forward_stage's elementwise work.
    auto finish = [&](auto mode_tag) {
      constexpr int MODE = decltype(mode_tag)::value;
      // Lanes of this warp on the same slot group, for the recorded maxima.
      const bool rec_any =
          MODE == 2 && __any_sync(0xffffffffu, (anyfl & F_RECORD) != 0);
      const unsigned peers =
          rec_any ? __match_any_sync(0xffffffffu, active ? g : -1) : 0u;
      const bool leader = rec_any && lane == __ffs(peers) - 1;
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = i0 + r;
        int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u (int views)
        bool viol = false;
        if (!dn[r]) {
          const bool check = MODE == 1 || (MODE == 2 && (fl[r] & F_CHECK));
          const bool record = MODE == 2 && (fl[r] & F_RECORD);
          const int idx = i * d.DzP + j0;
          const int zp = s.zpar[i];
          const float4 n4 =
              *reinterpret_cast<const float4*>(s.ZV + (zp ^ 1) * zstride + idx);
          const float zn[TJ] = {n4.x, n4.y, n4.z, n4.w};
          float zo[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
          float xu[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (MODE > 0) {
            const float4 o4 =
                *reinterpret_cast<const float4*>(s.ZV + zp * zstride + idx);
            const float4 x4 = *reinterpret_cast<const float4*>(s.S + idx);
            zo[0] = o4.x; zo[1] = o4.y; zo[2] = o4.z; zo[3] = o4.w;
            xu[0] = x4.x; xu[1] = x4.y; xu[2] = x4.z; xu[3] = x4.w;
          }
          float yn[TJ], sv[TJ];
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            const int j = j0 + c;
            yn[c] = tv[r][c] - zn[c];   // dual ascent
            sv[c] = zn[c] - yn[c];
            if (MODE > 0 && ((own >> c) & 1) && j < d.Dz) {
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
          store_owned(s.YG + idx, yn, own);
          store_owned(s.S + idx, sv, own);
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
    if (wfl == 0u) finish(std::integral_constant<int, 0>{});
    else if (wfl == (unsigned)F_CHECK) finish(std::integral_constant<int, 1>{});
    else finish(std::integral_constant<int, 2>{});
    ATM_WCLK(17);
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

// One lane's part of a backward register tile: acc[r][c] = sum over the
// lane's float4 steps q = h, h + H, ... (H = d.ksplit) of the depth of
// Sg[r][k] Wc[k][c] (Sg the tile's first S row, Wc Wb's column c0, read
// from device memory when G), summed in blocks of BWD_BLOCK steps (see
// there), each a fresh chain added to the running sum. KDU, KDZ, KH (K1's
// own body): DuP, DzP and H known at compile time, so a chain's steps
// unroll (the same sums).
template <int RI, bool G, int KDU = 0, int KDZ = 0, int KH = 0>
__device__ __forceinline__ void backward_product(const Dims& d,
                                                 const float* Sg,
                                                 const float* Wc, int h,
                                                 float (&acc)[RI][TJ]) {
  const int H = KH ? KH : d.ksplit;
  const int nq = (KDZ ? KDZ : d.DzP) >> 2;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < TJ; ++c) acc[r][c] = 0.0f;
  // FMA chains into dst over the lane's float4 steps q0, q0 + H, ... below
  // q1, a float4 step q at a time (ldw, lds: the row strides of Wb and S).
  auto chain = [&](float (&dst)[RI][TJ], int q0, int q1) {
    auto kstep = [&](int q, int ldw, int lds) {
      const int k = q << 2;
      float w[4][TJ];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = ldw4<G>(Wc + (k + kk) * ldw);
        w[kk][0] = wv.x; w[kk][1] = wv.y;
        w[kk][2] = wv.z; w[kk][3] = wv.w;
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float4 sv = *reinterpret_cast<const float4*>(Sg + r * lds + k);
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
          dst[r][c] = fmaf(sv.x, w[0][c], dst[r][c]);
          dst[r][c] = fmaf(sv.y, w[1][c], dst[r][c]);
          dst[r][c] = fmaf(sv.z, w[2][c], dst[r][c]);
          dst[r][c] = fmaf(sv.w, w[3][c], dst[r][c]);
        }
      }
    };
    if constexpr (KDZ > 0) {
      constexpr int STEPS = ((KDZ >> 2) + KH - 1) / KH;
#pragma unroll
      for (int st = 0; st < STEPS; ++st)
        if (q0 + st * KH < q1) kstep(q0 + st * KH, KDU, KDZ);
    } else {
      for (int q = q0; q < q1; q += H) kstep(q, d.DuP, d.DzP);
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

// Backward product: D[i][c] = sum_k S[i][k] Wb[k][c] + const_d[c], const_d
// the slot's row (the tick's row when tracking). A register tile is RI slots
// x TJ adjacent columns; its depth Dz is split over ksplit adjacent lanes
// (k-steps h, h + ksplit, ...), whose partial sums meet in a butterfly of
// shuffles (a fixed order). A lane sums its k-steps in blocks of BWD_BLOCK
// (see there). Frozen slots keep their D. SPLIT: the rows of slots on a
// split iteration are split_backward's.
template <int RI, bool GOPS, bool SPLIT = false>
__device__ inline void backward_stage(const Args& a, const Smem& s) {
  const Dims& d = a.d;
  const int H = d.ksplit;
  const int ncg = d.DuP / TJ;
  const int nitems = ncg * (d.tile / RI) * H;
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
      dn[r] = !active || s.done[i0 + r] == DONE ||
              (SPLIT && d.split && s.bsp[i0 + r] != 0);
      live |= !dn[r];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform
    float acc[RI][TJ];
    if (live) {
      // The split kernels read Wb from device memory on a launch that
      // splits (make_layout stages its fragments instead).
      const float* Sg = s.S + i0 * d.DzP;
      if constexpr (SPLIT && !GOPS) {
        if (d.split) backward_product<RI, true>(d, Sg, s.Wbg + c0, h, acc);
        else backward_product<RI, false>(d, Sg, s.Wb + c0, h, acc);
      } else {
        backward_product<RI, GOPS>(d, Sg, s.Wb + c0, h, acc);
      }
    } else {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < TJ; ++c) acc[r][c] = 0.0f;
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
    ATM_SCLK_BEGIN();
    if (!initial) retire_slot<ROLLOUT, GOPS, LONG>(a, s, i);
    __syncwarp();   // every lane is done with the slot's old state
    ATM_SCLK_MID();
    if (lane == 0) claim_slot<ROLLOUT>(a, s, i, initial);
    __syncwarp();
    load_slot<ADAPTIVE, ROLLOUT, GOPS>(a, s, i);
    ATM_SCLK_END(initial);
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
// CONES = true: the float32 kernels run the slack stage with the forward
// product in one pass where the wrapper gives its items (a.cone_items,
// cone_forward_stage), with the box-only iteration's barriers; the
// split-bf16 kernels, and the float32 ones without items, split it in
// three (forward product and clip, barrier, cone_stage, barrier,
// finish_stage). The frozen slots' U and X (retire_slot) need no cone
// code, since the new slacks they read are the projected ones. GOPS: the operators are read from device memory (the
// caller's padded copies) instead of being staged. RI: slots per register
// tile. SPLIT: the split-bf16 kernels (the mma passes before each
// product's stage).
template <int RI, bool ADAPTIVE, bool CONES, bool ROLLOUT, bool GOPS,
          bool SPLIT = false>
__device__ inline void run_block(const Args& a, float* base) {
  const Layout L = make_layout(a.d);
  const Smem s = carve<GOPS, SPLIT>(a, base, L);
  ATM_CLK_BEGIN();
  stage_block<GOPS, SPLIT>(a, L, base, s);
  __syncthreads();
  if (threadIdx.x < a.d.tile) s.list[threadIdx.x] = threadIdx.x;
  __syncthreads();
  constexpr bool LONG = RI == 4;   // long-depth sums (FWD_CHAIN)
  int live =
      refill_stage<ADAPTIVE, ROLLOUT, GOPS, LONG>(a, s, a.d.tile, true);
  // A split launch whose schedule splits no iteration (d.split = 0) has
  // no fragments and no bsp: it runs the float32 stages alone. The split
  // slots' stages run beside the float32 slots' with no barrier between
  // (disjoint rows), each split product first.
  const bool split = SPLIT && a.d.split;
  // The coned float32 kernels fold the cones into the forward stage where
  // the wrapper gives the items of that pass; else three passes.
  const bool fused_cones = CONES && !SPLIT && a.cone_items != nullptr;
  ATM_CLK_MARK();
  while (live > 0) {
    ATM_CLK_COUNT(7);
    if (split) {
      ATM_WCLK_BEGIN();
      split_forward<CONES, ROLLOUT>(a, s);
      ATM_WCLK(15);
    }
    ATM_WCLK_BEGIN();
    if constexpr (CONES && !SPLIT) {
      if (fused_cones) cone_forward_stage<RI, ROLLOUT, GOPS>(a, s);
      else forward_stage<RI, CONES, ROLLOUT, GOPS, SPLIT>(a, s);
    } else {
      forward_stage<RI, CONES, ROLLOUT, GOPS, SPLIT>(a, s);
    }
    ATM_WCLK(11);
    __syncthreads();
    ATM_CLK(0);
    if constexpr (CONES) {
      if (!fused_cones) {
        cone_stage(a, s);
        __syncthreads();
        ATM_CLK(1);
        finish_stage(a, s);
        __syncthreads();
        ATM_CLK(2);
      }
    }
    // A slot that freezes must be DONE before the backward stage reads the
    // flags; without checks a slot only turns CAPPED, which the backward
    // stage runs like a LIVE one, so no barrier is needed between the two.
    live = decide_stage<ADAPTIVE, ROLLOUT>(a, s);
    if (ADAPTIVE) live = __syncthreads_count(live);
    if (split) {
      ATM_WCLK_BEGIN();
      split_backward<GOPS>(a, s);
      ATM_WCLK(12);
    }
    ATM_WCLK_BEGIN();
    backward_stage<RI, GOPS, SPLIT>(a, s);
    ATM_WCLK(13);
    if (ADAPTIVE) __syncthreads();
    else live = __syncthreads_count(live);
    ATM_CLK(3);
    const int nret = *s.nref;   // slots waiting to be retired
    if (nret >= refill_min<RI>() || (live == 0 && nret > 0)) {
      live = refill_stage<ADAPTIVE, ROLLOUT, GOPS, LONG>(a, s, nret, false);
    } else if (threadIdx.x < a.d.tile && s.done[threadIdx.x] == CAPPED) {
      s.done[threadIdx.x] = DONE;   // it waits for a refill; the next
    }                               // forward stage's barrier orders this
    ATM_CLK(4);
  }
  ATM_CLK_END();
}

}  // namespace atm
