// Shared iteration body of the fused ADMM kernels (fixed solve, adaptive
// solve, in-kernel rollout) for Hopper (sm_90a), FP32 FMA only.
//
// Replaces the Pallas TPU kernel bodies of the JAX package:
//   accelerated_tinympc_tpu/ops/fused_admm.py  _iteration / _fixed_core /
//   _adaptive_core, and the tick body of ops/fused_rollout.py _kernel_rollout.
//
// What bounds it on this card: operations. One iteration of one instance is
// four small matrix-vector products (2*(Du*Dx + Du*Du + Dx*Du + Du*Du) FLOP,
// 22,464 at nx=12, nu=4, N=10) that depend on the previous iteration, while
// the bytes that must move are one read of the warm start and one write of
// the result per *solve*. So the design keeps everything on the SM:
//
//   * The operators are staged once per block into dynamic shared memory,
//     unpadded, as two concatenated matrices over z = [x | u] (width
//     Dz = Dx + Du):  Wf = [W_fd | W_gd] (Du x Dz)  maps D -> [X | U],
//                     Wb = [W_q ; W_r]  (Dz x Du)  maps S -> D.
//   * A block owns a tile of instances; their iterates (D, duals, slacks,
//     the hoisted x0 terms) stay in shared memory for all iterations.
//   * The forward product, the box clip, the dual update and the residual
//     terms are fused: the thread that finishes X[i][j] (or U) clips it,
//     updates the dual and writes S[i][j] = slack - dual for the backward
//     product.
//   * What limits a product here is not the FMA rate alone but the 128 B/clk an
//     SM can return from shared memory to registers. So each thread owns a
//     register tile of RI = 8 instances x TJ = 4 adjacent columns: per step
//     of four k it loads 8 + 4 float4 and does 128 FMAs (1.5 B/FMA; a tile
//     of 8 x 1 needs 4.5 B/FMA). The backward product has few columns (Du/4
//     column groups), so its depth Dz is split over H adjacent lanes whose
//     partial sums meet in a shuffle reduction.
//   * Early exit is per instance: a converged instance stops being written
//     (its shared-memory state *is* its result: D and the slacks from before
//     the check iteration, the duals from after it), a group of RI finished
//     instances skips its products, and the block leaves the loop when all
//     its instances are done (a block-uniform __syncthreads_and, so no
//     barrier is ever skipped by part of a block).
//   * A check costs no reduction: max_j r_j < tol holds exactly when no term
//     reaches the tolerance, so each thread only raises a flag for an
//     instance it sees violated. The residual maxima themselves are reduced
//     once per solve: at the last check for the instances still live, and
//     after the loop, together with U and X, for the frozen ones (recomputed
//     from the D they kept, in the same summation order).
//   * Slacks are double-buffered per instance (zpar) so that the check
//     iteration can read the old slack for the dual residual and still leave
//     it in place for an instance that freezes.
//
//   * Second-order cones (template parameter CONES; replaces the TPU
//     package's _cone_apply, ops/fused_admm.py) couple the ball and axis
//     entries of one knot, which in general sit in different threads' register
//     tiles (a knot of 12 states spans three column groups; a knot of 6 or 3
//     starts off the float4 grid). So with cones the stage splits in three
//     with a barrier between: the forward product clips as before and leaves
//     the pre-projection iterate (in S), the relaxed iterate + old dual (in
//     YG) and the clipped slack (in the new slack buffer) in shared memory;
//     a cone pass with one thread per (instance, knot) projects the clipped
//     slack in place, each cone in order (exact projection, three cases);
//     an elementwise pass, float4 per thread again, does dual ascent,
//     S = slack - dual, the residual terms and the violation flag against
//     the projected slack. It needs no buffer beyond the box layout's (only
//     the per-instance mu/shift rows when given). The box-only
//     instantiations keep the fused per-element path.
//
// Stage order per iteration is the reference's (src/tinympc/admm.cpp:117-150)
// in its folded condensed form: forward (x0 terms hoisted into XbUb), slack
// projection (fminf/fmaxf, safe with infinite bounds), dual ascent, then the
// linear-cost and backward stages as the single product against Wb plus the
// hoisted const_d.

#pragma once
#include <cuda_runtime.h>

namespace atm {

constexpr int RI = 8;  // instances per register tile; tile % RI == 0
constexpr int TJ = 4;  // adjacent columns per register tile (one float4)

constexpr int MAX_CONES = 8;  // input cones + state cones of one problem
constexpr int MAX_BALL = 8;   // ball entries of one cone

struct Dims {
  int nx, nu, N;    // knot widths and horizon
  int Dx, Du, Dz;   // N*nx, (N-1)*nu, Dx+Du
  int DuP, DzP;     // Du, Dz rounded up to 4 (float4 rows, zero padded)
  int tile;         // instances per block
  int ksplit;       // lanes sharing one backward tile's depth (power of 2)
  int ncp;          // cones with per-instance mu/shift rows (0 or all)
};

// The cones of one problem, input cones first, then state cones: per cone
// the ball indices and the axis index inside a knot, and the static mu and
// shift of ||w[ball]|| <= mu * (w[axis] + shift).
struct ConeTable {
  int nc_u, nc_x;
  int nball[MAX_CONES], axis[MAX_CONES], ball[MAX_CONES][MAX_BALL];
  float mu[MAX_CONES], shift[MAX_CONES];
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Dims make_dims(int nx, int nu, int N, int tile,
                                          int ncp = 0) {
  Dims d;
  d.nx = nx; d.nu = nu; d.N = N;
  d.Dx = N * nx; d.Du = (N - 1) * nu; d.Dz = d.Dx + d.Du;
  d.DuP = r4(d.Du); d.DzP = r4(d.Dz);
  d.tile = tile;
  d.ksplit = 1;
  d.ncp = ncp;
  return d;
}

// Offsets, in 4-byte words, of every region of the block's dynamic shared
// memory. The Python wrapper mirrors `total` (ops/fused_admm.py,
// kernel_smem_bytes) and the C entry refuses a launch if the two disagree.
struct Layout {
  int Wf, Wb, lo, hi, cd, A, Bm;             // staged once per block
  int D, S, YG, ZV, Xb, x0, u0, stat;        // per-instance floats
  int res, done, zpar, viol;                 // per-instance ints
  int cmu, csh;                              // per-instance cone mu, shift
  int total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = 0;
  L.Wf = o;   o += d.DuP * d.DzP;   // rows of DzP: float4 along columns
  L.Wb = o;   o += d.DzP * d.DuP;
  L.lo = o;   o += d.DzP;
  L.hi = o;   o += d.DzP;
  L.cd = o;   o += d.DuP;
  L.A = o;    o += r4(d.nx * d.nx);
  L.Bm = o;   o += r4(d.nx * d.nu);
  L.D = o;    o += r4(d.tile * d.DuP);
  L.S = o;    o += r4(d.tile * d.DzP);
  L.YG = o;   o += r4(d.tile * d.DzP);
  L.ZV = o;   o += r4(2 * d.tile * d.DzP);
  L.Xb = o;   o += r4(d.tile * d.DzP);
  L.x0 = o;   o += r4(2 * d.tile * d.nx);
  L.u0 = o;   o += r4(d.tile * d.nu);
  L.stat = o; o += r4(d.tile * 6);
  L.res = o;  o += r4(d.tile * 4);
  L.done = o; o += r4(d.tile);
  L.zpar = o; o += r4(d.tile);
  L.viol = o; o += r4(d.tile);
  L.cmu = o;  o += r4(d.ncp * d.tile);       // [cone][instance]
  L.csh = o;  o += r4(d.ncp * d.tile);
  L.total = o;
  return L;
}

// Everything a kernel needs; filled by the C entries in fused_admm.cu.
struct Args {
  // inputs, (B, .) row-major, unpadded
  const float *x0, *D0, *Y0, *G0, *Z0, *V0;
  // operators and vectors shared by the batch
  const float *Wf, *Wb, *Wx;    // (Du,Dz), (Dz,Du), (nx,Dz)
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
  int B, ticks, tracking;
  int max_iter, check_every, warmup;
  float rho, alpha, pri_tol, dua_tol;
  Dims d;
};

struct Smem {
  float *Wf, *Wb, *lo, *hi, *cd, *A, *Bm;
  float *D, *S, *YG, *ZV, *Xb, *x0, *u0, *stat;
  int *res, *done, *zpar, *viol;
  float *cmu, *csh;
};

__device__ inline Smem carve(float* base, const Layout& L) {
  Smem s;
  s.Wf = base + L.Wf; s.Wb = base + L.Wb; s.lo = base + L.lo;
  s.hi = base + L.hi; s.cd = base + L.cd; s.A = base + L.A;
  s.Bm = base + L.Bm; s.D = base + L.D; s.S = base + L.S;
  s.YG = base + L.YG; s.ZV = base + L.ZV; s.Xb = base + L.Xb;
  s.x0 = base + L.x0; s.u0 = base + L.u0; s.stat = base + L.stat;
  s.res = reinterpret_cast<int*>(base + L.res);
  s.done = reinterpret_cast<int*>(base + L.done);
  s.zpar = reinterpret_cast<int*>(base + L.zpar);
  s.viol = reinterpret_cast<int*>(base + L.viol);
  s.cmu = base + L.cmu; s.csh = base + L.csh;
  return s;
}

// ---------------------------------------------------------------- staging --

// Zero all per-instance state, then stage the operators (rows beyond Du / Dz
// stay zero so the float4 product loops can run over the padded depth).
__device__ inline void stage_block(const Args& a, const Layout& L,
                                   float* base, const Smem& s) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L.total; i += nt) base[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < d.Du * d.Dz; i += nt) {
    const int k = i / d.Dz, j = i - k * d.Dz;
    s.Wf[k * d.DzP + j] = a.Wf[i];
  }
  for (int i = tid; i < d.Dz * d.Du; i += nt) {
    const int k = i / d.Du, c = i - k * d.Du;
    s.Wb[k * d.DuP + c] = a.Wb[i];
  }
  for (int i = tid; i < d.Dz; i += nt) { s.lo[i] = a.lo[i]; s.hi[i] = a.hi[i]; }
  if (a.A != nullptr) {
    for (int i = tid; i < d.nx * d.nx; i += nt) s.A[i] = a.A[i];
    for (int i = tid; i < d.nx * d.nu; i += nt) s.Bm[i] = a.Bm[i];
  }
}

// Load x0 and the warm-start carry of the block's instances. with_duals =
// false leaves Y, G at zero (the rollout resets them every tick anyway).
__device__ inline void load_carry(const Args& a, const Smem& s, int b0, int nb,
                                  bool with_duals) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int it = tid; it < nb * d.nx; it += nt) {
    int i = it / d.nx, k = it - i * d.nx;
    s.x0[i * d.nx + k] = a.x0[(size_t)(b0 + i) * d.nx + k];
  }
  for (int it = tid; it < nb * d.Du; it += nt) {
    int i = it / d.Du, c = it - i * d.Du;
    size_t gsrc = (size_t)(b0 + i) * d.Du + c;
    s.D[i * d.DuP + c] = a.D0[gsrc];
    s.ZV[i * d.DzP + d.Dx + c] = a.Z0[gsrc];
    if (with_duals) s.YG[i * d.DzP + d.Dx + c] = a.Y0[gsrc];
  }
  for (int it = tid; it < nb * d.Dx; it += nt) {
    int i = it / d.Dx, j = it - i * d.Dx;
    size_t gsrc = (size_t)(b0 + i) * d.Dx + j;
    s.ZV[i * d.DzP + j] = a.V0[gsrc];
    if (with_duals) s.YG[i * d.DzP + j] = a.G0[gsrc];
  }
  // Per-instance cone parameters; the ragged edge keeps mu = shift = 0.
  for (int it = tid; it < d.ncp * nb; it += nt) {
    int c = it / nb, i = it - c * nb;
    s.cmu[c * d.tile + i] = a.cone_mu[(size_t)c * a.B + b0 + i];
    s.csh[c * d.tile + i] = a.cone_shift[(size_t)c * a.B + b0 + i];
  }
}

// Per-solve bookkeeping: live flags (the ragged edge of the batch is born
// done), statistics and residual accumulators cleared.
__device__ inline void reset_solve(const Args& a, const Smem& s, int nb) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < d.tile; i += nt) s.done[i] = (i >= nb) ? 1 : 0;
  for (int i = tid; i < d.tile * 6; i += nt) s.stat[i] = 0.0f;
  for (int i = tid; i < d.tile * 4; i += nt) s.res[i] = 0;
  for (int i = tid; i < d.tile; i += nt) s.viol[i] = 0;
}

// Hoisted x0 terms: XbUb[i][j] = sum_k x0[i][k] * Wx[k][j]  (Wx = [W_fx|W_gx]).
__device__ inline void compute_xbub(const Args& a, const Smem& s,
                                    const float* x0, int nb) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int it = tid; it < nb * d.Dz; it += nt) {
    int i = it / d.Dz, j = it - i * d.Dz;
    float acc = 0.0f;
    for (int k = 0; k < d.nx; ++k)
      acc = fmaf(x0[i * d.nx + k], __ldg(a.Wx + k * d.Dz + j), acc);
    s.Xb[i * d.DzP + j] = acc;
  }
}

// ----------------------------------------------------------------- stages --

// Forward product fused with slack projection, dual ascent and residuals.
// A thread owns one (group of RI instances, group of TJ adjacent columns of
// z) register tile at a time. The loop over items is warp-uniform so that
// the residual maxima can reduce with one redux per quantity over the lanes
// that share an instance group.
//   check    : flag every instance with a residual term at or above its
//              tolerance (s.viol); costs no reduction across lanes
//   record   : accumulate the four residual maxima of this iteration
//   keep_u0  : keep the first-knot controls of this iteration in s.u0
//   Uout/Xout: not nullptr -> write this iteration's U, X to global
// CONES = true: the stage ends after the box clip; it leaves the
// pre-projection iterate in S (and in u0, U, X where asked), t = relaxed
// iterate + old dual in YG and the clipped slack in the new slack buffer,
// for cone_stage and finish_stage.
template <bool CONES>
__device__ inline void forward_stage(const Args& a, const Smem& s, int b0,
                                     bool check, bool record, bool keep_u0,
                                     float* Uout, float* Xout) {
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
    bool live = false;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      dn[r] = !active || s.done[i0 + r] != 0;
      live |= !dn[r];
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
      for (int k = 0; k < d.DuP; k += 4) {
        float w[4][TJ];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv =
              *reinterpret_cast<const float4*>(Wc + (k + kk) * d.DzP);
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
    if constexpr (CONES) {
      const float4 l4 = *reinterpret_cast<const float4*>(s.lo + j0);
      const float4 h4 = *reinterpret_cast<const float4*>(s.hi + j0);
      const float lo[TJ] = {l4.x, l4.y, l4.z, l4.w};
      const float hi[TJ] = {h4.x, h4.y, h4.z, h4.w};
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
        const float xu[TJ] = {xb4.x + acc[r][0], xb4.y + acc[r][1],
                              xb4.z + acc[r][2], xb4.w + acc[r][3]};
        const float yo[TJ] = {y4.x, y4.y, y4.z, y4.w};
        const float zo[TJ] = {z4.x, z4.y, z4.z, z4.w};
        float t[TJ], zn[TJ];
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
          const int j = j0 + c;
          const float xr =
              relax ? alpha * xu[c] + (1.0f - alpha) * zo[c] : xu[c];
          t[c] = xr + yo[c];
          zn[c] = fminf(fmaxf(t[c], lo[c]), hi[c]);  // box clip, inf-safe
          if (j < d.Dz) {
            if (Uout != nullptr) {
              if (j < d.Dx) Xout[(size_t)(b0 + i) * d.Dx + j] = xu[c];
              else Uout[(size_t)(b0 + i) * d.Du + (j - d.Dx)] = xu[c];
            }
            if (keep_u0 && j >= d.Dx && j < d.Dx + d.nu)
              s.u0[i * d.nu + (j - d.Dx)] = xu[c];
          }
        }
        *reinterpret_cast<float4*>(s.S + idx) =
            make_float4(xu[0], xu[1], xu[2], xu[3]);
        *reinterpret_cast<float4*>(s.YG + idx) =
            make_float4(t[0], t[1], t[2], t[3]);
        *reinterpret_cast<float4*>(s.ZV + (zp ^ 1) * zstride + idx) =
            make_float4(zn[0], zn[1], zn[2], zn[3]);
      }
      continue;
    }
    float lo[TJ], hi[TJ];
    {
      const float4 l4 = *reinterpret_cast<const float4*>(s.lo + j0);
      const float4 h4 = *reinterpret_cast<const float4*>(s.hi + j0);
      lo[0] = l4.x; lo[1] = l4.y; lo[2] = l4.z; lo[3] = l4.w;
      hi[0] = h4.x; hi[1] = h4.y; hi[2] = h4.z; hi[3] = h4.w;
    }
    // Lanes of this warp that work on the same instance group: items run
    // with the lanes, so they are the lanes from the group's first item to
    // its last (threads beyond the last item repeat it and count with it).
    unsigned peers = 0u;
    if (record) {
      const int item0 = base + (threadIdx.x & ~31);
      const int first = max(g * ncg - item0, 0);
      const int end =
          g == (nitems - 1) / ncg ? 32 : min((g + 1) * ncg - item0, 32);
      peers = (end >= 32 ? 0xffffffffu : (1u << end) - 1u) &
              ~((1u << first) - 1u);
    }
    const bool leader = record && lane == __ffs(peers) - 1;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = i0 + r;
      const int idx = i * d.DzP + j0;
      int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u as int views
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
        float yn[TJ], zn[TJ], sv[TJ];
#pragma unroll
        for (int c = 0; c < TJ; ++c) {
          const int j = j0 + c;
          const float xu = xb[c] + acc[r][c];   // pre-projection X or U
          const float xr = relax ? alpha * xu + (1.0f - alpha) * zo[c] : xu;
          const float t = xr + yo[c];
          zn[c] = fminf(fmaxf(t, lo[c]), hi[c]);  // box clip, inf-safe
          yn[c] = t - zn[c];                      // dual ascent
          sv[c] = zn[c] - yn[c];
          if (j < d.Dz) {
            if (Uout != nullptr) {
              if (j < d.Dx) Xout[(size_t)(b0 + i) * d.Dx + j] = xu;
              else Uout[(size_t)(b0 + i) * d.Du + (j - d.Dx)] = xu;
            }
            if (keep_u0 && j >= d.Dx && j < d.Dx + d.nu)
              s.u0[i * d.nu + (j - d.Dx)] = xu;
            const float pr = fabsf(xu - zn[c]);
            const float dr = fabsf(zo[c] - zn[c]);
            // max_j(.) < tol  <=>  every term < tol (a NaN fails both ways).
            if (check)
              viol |= !(pr < a.pri_tol) || !(dr * a.rho < a.dua_tol);
            if (record) {
              // |.| >= 0: the int view orders like the float, NaN on top.
              const int o = j < d.Dx ? 0 : 2;
              mx[o] = max(mx[o], __float_as_int(pr));
              mx[o + 1] = max(mx[o + 1], __float_as_int(dr));
            }
          }
        }
        // Columns beyond Dz are padding: operators, bounds and Xb are zero
        // there, so the stored values stay zero.
        *reinterpret_cast<float4*>(s.YG + idx) =
            make_float4(yn[0], yn[1], yn[2], yn[3]);
        *reinterpret_cast<float4*>(s.ZV + (zp ^ 1) * zstride + idx) =
            make_float4(zn[0], zn[1], zn[2], zn[3]);
        *reinterpret_cast<float4*>(s.S + idx) =
            make_float4(sv[0], sv[1], sv[2], sv[3]);
        if (viol) s.viol[i] = 1;
      }
      if (record) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = __reduce_max_sync(peers, mx[q]);
          if (leader && m > 0) atomicMax(&s.res[i * 4 + q], m);
        }
      }
    }
  }
}

// Cone projections, one thread per (instance, knot): knots 0..N-1 are the
// state knots, N..2N-2 the input knots. forward_stage<true> has left the
// box-clipped slack in the new slack buffer; each cone of the knot's kind is
// applied to it in order, in place (exact projection of (w[ball], w[axis] +
// shift) onto ||v|| <= mu s: inside -> unchanged, polar -> 0, else the
// boundary point; a == 0 guarded). mu and shift come from the per-instance
// rows when given (d.ncp > 0), else from the table: the arithmetic is the
// same either way.
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
    if (s.done[i] != 0) continue;
    const bool is_x = k < d.N;
    const int j0 = is_x ? k * d.nx : d.Dx + (k - d.N) * d.nu;
    float* zn = s.ZV + (s.zpar[i] ^ 1) * zstride + i * d.DzP + j0;
    const int c0 = is_x ? ct.nc_u : 0;
    const int c1 = is_x ? ct.nc_u + ct.nc_x : ct.nc_u;
    for (int q = c0; q < c1; ++q) {
      const float mu = d.ncp ? s.cmu[q * d.tile + i] : ct.mu[q];
      const float shift = d.ncp ? s.csh[q * d.tile + i] : ct.shift[q];
      float a2 = 0.0f;
      for (int b = 0; b < ct.nball[q]; ++b) {
        const float v = zn[ct.ball[q][b]];
        a2 = fmaf(v, v, a2);
      }
      const float sv = zn[ct.axis[q]] + shift;
      const float an = sqrtf(a2);
      const bool inside = an <= mu * sv;
      const bool polar = mu * an <= -sv;
      const float cc = (mu * an + sv) / (mu * mu + 1.0f);
      const float safe_a = a2 == 0.0f ? 1.0f : an;
      const float scale = polar ? 0.0f : (inside ? 1.0f : mu * cc / safe_a);
      const float s_new = inside ? sv : (polar ? 0.0f : cc);
      for (int b = 0; b < ct.nball[q]; ++b) zn[ct.ball[q][b]] *= scale;
      zn[ct.axis[q]] = s_new - shift;
    }
  }
}

// Closes the coned slack stage, one thread per (instance, group of TJ
// columns): dual ascent against the *projected* slack, S = slack - dual, the
// residual terms, the violation flag and (on the recording iteration) the
// maxima. Reads t = relaxed iterate + old dual from YG, the pre-projection
// iterate from S and the projected slack from the new slack buffer.
__device__ inline void finish_stage(const Args& a, const Smem& s, bool check,
                                    bool record) {
  const Dims& d = a.d;
  const int ncg = d.DzP / TJ;
  const int zstride = d.tile * d.DzP;
  for (int item = threadIdx.x; item < d.tile * ncg; item += blockDim.x) {
    const int i = item / ncg, j0 = (item - i * ncg) * TJ;
    if (s.done[i] != 0) continue;
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
      if (j < d.Dz) {
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
    if (viol) s.viol[i] = 1;
    if (record) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (mx[q] > 0) atomicMax(&s.res[i * 4 + q], mx[q]);
    }
  }
}

// One thread per instance closes the iteration's bookkeeping: keep the
// recorded residuals, freeze the instance if a check flagged no violation (it
// then keeps its old D and old slacks: zpar is not flipped, the backward
// stage skips it), otherwise adopt the new slacks. Returns true, block-uniformly, when a
// check found every instance of the block done.
template <bool ADAPTIVE>
__device__ inline bool decide_stage(const Args& a, const Smem& s, int it,
                                    bool is_check, bool record) {
  const int i = threadIdx.x;
  int mydone = 1;
  if (i < a.d.tile) {
    int dflag = s.done[i];
    if (!dflag) {
      bool frozen = false;
      if (record) {
        const float ps = __int_as_float(s.res[i * 4 + 0]);
        const float ds = __int_as_float(s.res[i * 4 + 1]) * a.rho;
        const float pu = __int_as_float(s.res[i * 4 + 2]);
        const float du = __int_as_float(s.res[i * 4 + 3]) * a.rho;
        s.stat[i * 6 + 2] = ps; s.stat[i * 6 + 3] = ds;
        s.stat[i * 6 + 4] = pu; s.stat[i * 6 + 5] = du;
        s.res[i * 4 + 0] = 0; s.res[i * 4 + 1] = 0;
        s.res[i * 4 + 2] = 0; s.res[i * 4 + 3] = 0;
      }
      if (ADAPTIVE && is_check) {
        if (s.viol[i] == 0) {
          frozen = true;
          s.stat[i * 6 + 0] = (float)it;
          s.stat[i * 6 + 1] = 1.0f;
          s.done[i] = 1;
          dflag = 1;
        }
        s.viol[i] = 0;
      }
      if (!frozen) s.zpar[i] ^= 1;
    }
    mydone = dflag;
  }
  if (ADAPTIVE && is_check) return __syncthreads_and(mydone) != 0;
  return false;
}

// Backward product: D[i][c] = sum_k S[i][k] * Wb[k][c] + const_d[c]. A
// register tile is RI instances x TJ adjacent columns; its depth Dz is split
// over ksplit adjacent lanes (k-steps h, h + ksplit, ...), whose partial
// sums meet in a butterfly of shuffles. Finished instances keep their D.
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
      dn[r] = !active || s.done[i0 + r] != 0;
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
      for (int q = h; q < nq; q += H) {
        const int k = q << 2;
        float w[4][TJ];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv =
              *reinterpret_cast<const float4*>(Wc + (k + kk) * d.DuP);
          w[kk][0] = wv.x; w[kk][1] = wv.y; w[kk][2] = wv.z; w[kk][3] = wv.w;
        }
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const float4 sv =
              *reinterpret_cast<const float4*>(Sg + r * d.DzP + k);
#pragma unroll
          for (int c = 0; c < TJ; ++c) {
            acc[r][c] = fmaf(sv.x, w[0][c], acc[r][c]);
            acc[r][c] = fmaf(sv.y, w[1][c], acc[r][c]);
            acc[r][c] = fmaf(sv.z, w[2][c], acc[r][c]);
            acc[r][c] = fmaf(sv.w, w[3][c], acc[r][c]);
          }
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
      const float4 cd = *reinterpret_cast<const float4*>(s.cd + c0);
#pragma unroll
      for (int r = 0; r < RI; ++r)
        if (!dn[r])
          *reinterpret_cast<float4*>(s.D + (i0 + r) * d.DuP + c0) =
              make_float4(acc[r][0] + cd.x, acc[r][1] + cd.y,
                          acc[r][2] + cd.z, acc[r][3] + cd.w);
    }
  }
}

// Results of the instances that froze at a check, one warp per instance: U
// and X are the pre-projection iterate of that check, Xb + D Wf with the D
// they kept, summed in the forward stage's order; the residuals are those
// of that check, from the old slacks (the buffer zpar points at) and the
// new ones (the other buffer, untouched since).
__device__ inline void emit_frozen(const Args& a, const Smem& s, int b0,
                                   float* Uout, float* Xout) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int zstride = d.tile * d.DzP;
  for (int i = threadIdx.x >> 5; i < d.tile; i += blockDim.x >> 5) {
    if (s.stat[i * 6 + 1] == 0.0f) continue;  // warp-uniform
    const int zp = s.zpar[i];
    int mx[4] = {0, 0, 0, 0};  // pri_x, dua_x, pri_u, dua_u as int views
    for (int j = lane; j < d.Dz; j += 32) {
      float acc = 0.0f;
      for (int k = 0; k < d.Du; ++k)
        acc = fmaf(s.D[i * d.DuP + k], s.Wf[k * d.DzP + j], acc);
      const int idx = i * d.DzP + j;
      const float xu = s.Xb[idx] + acc;
      if (j < d.Dx) Xout[(size_t)(b0 + i) * d.Dx + j] = xu;
      else Uout[(size_t)(b0 + i) * d.Du + (j - d.Dx)] = xu;
      const float zo = s.ZV[zp * zstride + idx];
      const float zn = s.ZV[(zp ^ 1) * zstride + idx];
      const int o = j < d.Dx ? 0 : 2;
      mx[o] = max(mx[o], __float_as_int(fabsf(xu - zn)));
      mx[o + 1] = max(mx[o + 1], __float_as_int(fabsf(zo - zn)));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[q] = __reduce_max_sync(0xffffffffu, mx[q]);
    if (lane == 0) {
      s.stat[i * 6 + 2] = __int_as_float(mx[0]);
      s.stat[i * 6 + 3] = __int_as_float(mx[1]) * a.rho;
      s.stat[i * 6 + 4] = __int_as_float(mx[2]);
      s.stat[i * 6 + 5] = __int_as_float(mx[3]) * a.rho;
    }
  }
}

// ------------------------------------------------------------- solve core --

// The ADMM loop of one solve on the block's shared-memory state. Expects
// D, YG, ZV[zpar], XbUb, cd loaded, reset_solve done, and a barrier since.
//   ADAPTIVE = false: max_iter iterations; residuals of the final iteration
//     against the pre-save slacks; solved stays 0.
//   ADAPTIVE = true: a check where it > warmup and it % check_every == 0;
//     an instance that never converges returns the live values after
//     max_iter iterations and the residuals of its last check. The residual
//     columns are filled only where U and X are asked for (Uout != nullptr).
// Afterwards shared memory holds each instance's result (a barrier has
// passed since its last write); U and X are in global memory where asked.
// CONES = true splits the slack stage (forward product and clip, barrier,
// cone_stage, barrier, finish_stage); emit_frozen needs no cone code, since
// the new slacks it reads are the projected ones.
template <bool ADAPTIVE, bool CONES>
__device__ inline void solve_core(const Args& a, const Smem& s, int b0,
                                  float* Uout, float* Xout, bool keep_u0) {
  // The last iteration that checks: its residuals are what an instance that
  // never converges reports.
  const int last_check =
      ADAPTIVE ? (a.max_iter / a.check_every) * a.check_every : 0;
  for (int it = 1; it <= a.max_iter; ++it) {
    const bool is_last = it == a.max_iter;
    const bool is_check =
        ADAPTIVE && it > a.warmup && (it % a.check_every) == 0;
    const bool record = ADAPTIVE ? is_check && it == last_check : is_last;
    forward_stage<CONES>(a, s, b0, is_check, record,
                         keep_u0 && (is_check || is_last),
                         is_last ? Uout : nullptr, Xout);
    __syncthreads();
    if constexpr (CONES) {
      cone_stage(a, s);
      __syncthreads();
      finish_stage(a, s, is_check, record);
      __syncthreads();
    }
    if (decide_stage<ADAPTIVE>(a, s, it, is_check, record)) break;
    backward_stage(a, s);
    __syncthreads();
  }
  const int i = threadIdx.x;
  if (i < a.d.tile && s.stat[i * 6 + 1] == 0.0f)
    s.stat[i * 6 + 0] = (float)a.max_iter;
  __syncthreads();
  if (ADAPTIVE && Uout != nullptr) {
    emit_frozen(a, s, b0, Uout, Xout);
    __syncthreads();
  }
}

// Write the block's results: carries (D; duals; the slack buffer zpar points
// at) and statistics. U and X were written by the forward stage.
__device__ inline void write_result(const Args& a, const Smem& s, int b0,
                                    int nb) {
  const Dims& d = a.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int zstride = d.tile * d.DzP;
  for (int it = tid; it < nb * d.Dz; it += nt) {
    const int i = it / d.Dz, j = it - i * d.Dz;
    const int idx = i * d.DzP + j;
    const float yg = s.YG[idx];
    const float zv = s.ZV[s.zpar[i] * zstride + idx];
    if (j < d.Dx) {
      a.G[(size_t)(b0 + i) * d.Dx + j] = yg;
      a.V[(size_t)(b0 + i) * d.Dx + j] = zv;
    } else {
      a.Y[(size_t)(b0 + i) * d.Du + (j - d.Dx)] = yg;
      a.Z[(size_t)(b0 + i) * d.Du + (j - d.Dx)] = zv;
    }
  }
  for (int it = tid; it < nb * d.Du; it += nt) {
    const int i = it / d.Du, c = it - i * d.Du;
    a.D[(size_t)(b0 + i) * d.Du + c] = s.D[i * d.DuP + c];
  }
  for (int it = tid; it < nb * 6; it += nt)
    a.stats[(size_t)b0 * 6 + it] = s.stat[it];
}

}  // namespace atm
