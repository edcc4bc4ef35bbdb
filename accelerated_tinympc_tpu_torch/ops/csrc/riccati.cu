// Batched infinite-horizon Riccati precompute for Hopper (sm_90a), one
// distinct plant per instance, FP32.
//
//   riccati_fixed_point_kernel  replaces accelerated_tinympc_tpu/ops/
//                               riccati_kernel.py _kernel (fixed point from
//                               P0 = rho I or a warm P0, K0)
//   riccati_newton_kernel       replaces riccati_kernel.py _kernel_newton
//                               (Newton-Kleinman from a stabilising K0)
//
// What bounds it: operations. One fixed-point step is 2(2 nu nx^2 + nu^2 nx
// + nu nx^2 + 2 nx^3) FLOP per instance (10,752 at nx=12, nu=4) on ~2 KB
// that stay on the SM; global memory is read once and written once per
// instance. So the design is about issuing FMAs, not moving bytes.
//
// Two designs, one function.
//
// Lane groups (group_*_kernel<NX, NU, G>), for the sizes the port's paths
// use (12/4, 6/3, 8/3, 6/8, 5/2; riccati_kernel.py GROUP_SHAPES). Shapes are
// compile-time, so every loop unrolls into registers with no index
// arithmetic. An instance belongs to a group of G adjacent lanes (32 / G
// instances per warp); lane g of a group owns the C = NX / G columns
// j = g + G c of every nx x nx iterate and of the gain, held in registers.
// A product C(:, j) = sum_k X(:, k) Y(k, j) then reads the columns X(:, k)
// from the group's slice of shared memory, where the group's lanes all read
// the same address (a broadcast; the slices are 4 mod 32 floats apart, so
// the groups of a warp hit distinct banks) and multiply it into the C
// columns of Y they hold: 4 C FMAs per 16-byte load. Every lane works in
// every product stage. Matrices live in shared memory column by column
// (P, A and the Newton iterates; row j is column j) or row by row (B); no
// product assumes P symmetric. The nu x nu system R1 + B'PB is summed,
// symmetrised, factored and solved redundantly by every lane in registers
// (a Cholesky of nu <= 8, unrolled; nu^2 nx FMAs a lane). Every product
// sums in the order of the general kernel's.
// P is symmetrised through one exchange: each lane writes its
// columns of A'P(A - BK), reads the matching rows, and keeps 0.5(a + b),
// which both owners of an entry pair compute alike (so P is exactly
// symmetric). A group leaves the loop on its own (per-instance exit); its
// barriers and shuffles name its own lanes only.
//
// General (general_*_kernel), for every other size whose working set fits a
// block's shared memory: one warp per instance, matrices in the warp's
// slice of shared memory, each small product spread over the lanes by
// output entry, the nu x nu Cholesky on lane 0. Slower; no size limit but
// shared memory.
//
// Semantics of both: the reference's stopping rule (src/tinympc/
// codegen.cpp:273-285) per instance: the loop ends at the first step whose
// max|Knew - K| is below the tolerance, and the K and P returned are that
// step's iterate. A non-finite step also ends the loop (its delta fails
// `delta >= tol`) and the non-finite values are returned as they are: the
// Newton kernel reports a K0 that does not stabilise its plant this way.
// Then Quu_inv, AmBKt and coeff_d2p from the frozen K, P (codegen.cpp:
// 287-292). Sums run in other orders than in the plain version.
//
// Plain C interface (loaded with ctypes): entries launch on the given stream,
// do not synchronise, allocate nothing and return cudaGetLastError(), or -1
// when the sizes or the caller's shared-memory count do not match the
// kernel's own plan.

#include <cuda_runtime.h>

namespace atm {

constexpr int RIC_THREADS = 128;   // threads per block, both designs

struct RicArgs {
  const float *A, *B, *Q, *R, *rho;  // (Bn,nx,nx) (Bn,nx,nu) (Bn,nx) (Bn,nu) (Bn)
  const float *P0, *K0;              // warm start (Bn,nx,nx), (Bn,nu,nx) or null
  float *Kinf, *Pinf, *Quu_inv, *AmBKt, *coeff;
  int* iters;                        // (Bn)
  int Bn, nx, nu;
  int max_iters, inner_iters;
  float tol;
};

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }

// ======================================================= lane-group design ==

template <int NX, int NU, int G>
struct GShape {
  static constexpr int C = NX / G;       // columns per lane
  static constexpr int LX = r4(NX);      // floats per nx-long smem row
  static constexpr int LU = r4(NU);      // floats per nu-long smem row
  // Per instance: P (or the Stein sum S) by columns, A by columns, the
  // exchange buffer, B by rows, B'P by columns; Newton adds M_j by columns
  // and K by columns.
  __host__ __device__ static constexpr int base_floats(bool newton) {
    return (3 + (newton ? 1 : 0)) * NX * LX + (2 + (newton ? 1 : 0)) * NX * LU;
  }
  // Slices 4 mod 32 floats apart: the broadcast loads of the groups of a
  // warp fall on distinct banks.
  __host__ __device__ static constexpr int stride(bool newton) {
    return base_floats(newton) + ((36 - base_floats(newton) % 32) % 32);
  }
  static_assert(NX % G == 0 && 32 % G == 0, "G lanes must split the columns");
};

// An instance's group of G lanes: this lane's index in it, the mask of its
// lanes (for barriers, shuffles and votes that name only them).
template <int G>
struct Group {
  int g;
  unsigned mask;
  __device__ Group() {
    const int lane = threadIdx.x & 31;
    g = lane & (G - 1);
    mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane - g);
  }
  __device__ void sync() const { __syncwarp(mask); }
  __device__ float max(float v) const {
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      v = fmaxf(v, __shfl_xor_sync(mask, v, off));
    return v;
  }
};

template <int N>
__device__ __forceinline__ void ld_row(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < r4(N); q += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + q);
    if (q + 0 < N) v[q + 0] = t.x;
    if (q + 1 < N) v[q + 1] = t.y;
    if (q + 2 < N) v[q + 2] = t.z;
    if (q + 3 < N) v[q + 3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void st_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < r4(N); q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(
        v[q], q + 1 < N ? v[q + 1] : 0.0f, q + 2 < N ? v[q + 2] : 0.0f,
        q + 3 < N ? v[q + 3] : 0.0f);
}

// Lower Cholesky factor of the symmetric positive definite M, in registers.
template <int N>
__device__ __forceinline__ void chol_reg(float (&L)[N][N],
                                         const float (&M)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float sj = M[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) sj -= L[j][t] * L[j][t];
    const float ljj = sqrtf(sj);
    L[j][j] = ljj;
    const float inv = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float sv = M[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) sv -= L[i][t] * L[j][t];
      L[i][j] = sv * inv;
    }
  }
}

// x <- (L L')^-1 x, in registers.
template <int N>
__device__ __forceinline__ void chol_solve_reg(const float (&L)[N][N],
                                               float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float sv = x[i];
#pragma unroll
    for (int t = 0; t < i; ++t) sv -= L[i][t] * x[t];
    x[i] = sv / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float sv = x[i];
#pragma unroll
    for (int t = i + 1; t < N; ++t) sv -= L[t][i] * x[t];
    x[i] = sv / L[i][i];
  }
}

// One instance's slice of shared memory.
template <int NX, int NU, int G>
struct GMats {
  using S = GShape<NX, NU, G>;
  float *Pc, *Ac, *X, *Br, *BtPc, *Mc, *Kc;
  __device__ GMats(float* w, bool newton) {
    Pc = w; w += NX * S::LX;
    Ac = w; w += NX * S::LX;
    X = w;  w += NX * S::LX;
    Br = w; w += NX * S::LU;
    BtPc = w; w += NX * S::LU;
    Mc = newton ? w : nullptr; w += newton ? NX * S::LX : 0;
    Kc = newton ? w : nullptr;
  }
};

// The gain update Kn = (R1 + B'PB)^-1 B'PA of the reference, with P in
// m.Pc. Each lane gets the columns it owns of Kn (kn) and of B'P (left in
// m.BtPc, all columns, for the caller); L is the factor of the symmetrised
// system. ac: the lane's columns of A.
template <int NX, int NU, int G>
__device__ __forceinline__ void group_gain(
    const Group<G>& grp, const GMats<NX, NU, G>& m, const float (&Ra)[NU],
    const float (&ac)[NX / G][NX], float (&kn)[NX / G][NU],
    float (&L)[NU][NU]) {
  constexpr int C = NX / G, LX = GShape<NX, NU, G>::LX,
                LU = GShape<NX, NU, G>::LU;
  // B'P(:, j) = sum_k B(k, :)' P(k, j)
  float bt[C][NU];
  {
    float pc[C][NX];
#pragma unroll
    for (int c = 0; c < C; ++c) ld_row<NX>(pc[c], m.Pc + (grp.g + G * c) * LX);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < NU; ++i) bt[c][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      float b[NU];
      ld_row<NU>(b, m.Br + k * LU);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < NU; ++i) bt[c][i] = fmaf(b[i], pc[c][k], bt[c][i]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) st_row<NU>(m.BtPc + (grp.g + G * c) * LU, bt[c]);
  grp.sync();   // B'P visible to the group
  // In one pass over the columns of B'P: B'PB = sum_k B'P(:, k) B(k, :),
  // whole and in k order on every lane (the nu x nu system is factored
  // redundantly), and B'PA(:, j) = sum_k B'P(:, k) A(k, j) for the lane's j.
  float M[NU][NU];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int q = 0; q < NU; ++q) M[a][q] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < NU; ++i) kn[c][i] = 0.0f;
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    float v[NU], b[NU];
    ld_row<NU>(v, m.BtPc + k * LU);
    ld_row<NU>(b, m.Br + k * LU);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int q = 0; q < NU; ++q) M[a][q] = fmaf(v[a], b[q], M[a][q]);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < NU; ++i) kn[c][i] = fmaf(v[i], ac[c][k], kn[c][i]);
  }
  // R1 + 0.5 (M + M'), then Kn(:, j) by the factor.
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    M[a][a] = 0.5f * (M[a][a] + M[a][a]) + Ra[a];
#pragma unroll
    for (int q = a + 1; q < NU; ++q) {
      M[a][q] = 0.5f * (M[a][q] + M[q][a]);
      M[q][a] = M[a][q];
    }
  }
  chol_reg<NU>(L, M);
#pragma unroll
  for (int c = 0; c < C; ++c) chol_solve_reg<NU>(L, kn[c]);
}

// Columns of A - B K from the lane's columns of A and K.
template <int NX, int NU, int G>
__device__ __forceinline__ void group_closed_loop(
    const GMats<NX, NU, G>& m, const float (&ac)[NX / G][NX],
    const float (&kc)[NX / G][NU], float (&t)[NX / G][NX]) {
  constexpr int C = NX / G, LU = GShape<NX, NU, G>::LU;
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    float b[NU];
    ld_row<NU>(b, m.Br + r * LU);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float bk = 0.0f;
#pragma unroll
      for (int i = 0; i < NU; ++i) bk = fmaf(b[i], kc[c][i], bk);
      t[c][r] = ac[c][r] - bk;
    }
  }
}

// out(:, j) = sum_k Xc(k)(:) y(k, j), Xc a column-stored matrix in smem, y
// the lane's columns.
template <int NX, int C, int LX>
__device__ __forceinline__ void cols_times(float (&out)[C][NX],
                                           const float* Xc,
                                           const float (&y)[C][NX]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < NX; ++r) out[c][r] = 0.0f;
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    float x[NX];
    ld_row<NX>(x, Xc + k * LX);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < NX; ++r) out[c][r] = fmaf(x[r], y[c][k], out[c][r]);
  }
}

// out(a, j) = sum_k Xc(a)(k) y(k, j) = (X' y)(a, j), Xc column-stored;
// ADD: out(a, j) += that sum (the sum formed first, then added).
template <int NX, int C, int LX, bool ADD = false>
__device__ __forceinline__ void cols_t_times(float (&out)[C][NX],
                                             const float* Xc,
                                             const float (&y)[C][NX]) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    float x[NX];
    ld_row<NX>(x, Xc + a * LX);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = fmaf(x[k], y[c][k], acc);
      out[c][a] = ADD ? out[c][a] + acc : acc;
    }
  }
}

// P <- 0.5 (T + T') + diag(dg) from the lane's columns of T; the new columns
// go to the lane's registers (t, in place) and to m.Pc. Ends with the
// group's barrier.
template <int NX, int NU, int G, bool DIAG>
__device__ __forceinline__ void group_symmetrise(
    const Group<G>& grp, const GMats<NX, NU, G>& m, float (&t)[NX / G][NX],
    const float (&dg)[NX / G]) {
  constexpr int C = NX / G, LX = GShape<NX, NU, G>::LX;
#pragma unroll
  for (int c = 0; c < C; ++c) st_row<NX>(m.X + (grp.g + G * c) * LX, t[c]);
  grp.sync();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = grp.g + G * c;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float h = 0.5f * (t[c][k] + m.X[k * LX + j]);
      t[c][k] = DIAG && k == j ? h + dg[c] : h;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) st_row<NX>(m.Pc + (grp.g + G * c) * LX, t[c]);
  grp.sync();
}

// max |kn - kc| over the group; NaN if any entry is not a number.
template <int NX, int NU, int G>
__device__ __forceinline__ float group_delta(const Group<G>& grp,
                                             const float (&kn)[NX / G][NU],
                                             const float (&kc)[NX / G][NU]) {
  float d = 0.0f;
  bool bad = false;
#pragma unroll
  for (int c = 0; c < NX / G; ++c)
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const float v = fabsf(kn[c][i] - kc[c][i]);
      bad |= !(v == v);
      d = fmaxf(d, v);
    }
  d = grp.max(d);
  // fmaxf drops a NaN: carry it apart so a non-finite step ends the loop.
  if (__any_sync(grp.mask, bad)) d = __int_as_float(0x7fc00000);
  return d;
}

// The plant of instance b into the group's slice: A by columns, B by rows;
// the lane's columns of A, its entries of Q + rho and all of R + rho.
template <int NX, int NU, int G>
__device__ __forceinline__ void group_load(
    const RicArgs& a, const Group<G>& grp, const GMats<NX, NU, G>& m, int b,
    float (&ac)[NX / G][NX], float (&Qa)[NX / G], float (&Ra)[NU]) {
  constexpr int C = NX / G, LX = GShape<NX, NU, G>::LX,
                LU = GShape<NX, NU, G>::LU;
  const float rho = __ldg(a.rho + b);
  const float* A = a.A + (size_t)b * NX * NX;
  const float* B = a.B + (size_t)b * NX * NU;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = grp.g + G * c;
#pragma unroll
    for (int r = 0; r < NX; ++r) ac[c][r] = __ldg(A + r * NX + j);
    st_row<NX>(m.Ac + j * LX, ac[c]);
    float brow[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) brow[i] = __ldg(B + j * NU + i);
    st_row<NU>(m.Br + j * LU, brow);
    Qa[c] = __ldg(a.Q + (size_t)b * NX + j) + rho;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) Ra[i] = __ldg(a.R + (size_t)b * NU + i) + rho;
}

// Quu_inv, AmBKt, coeff_d2p from the frozen K (kc) and P (pc, the lane's
// columns; m.Pc), and the write of all six outputs (reference
// codegen.cpp:287-292).
template <int NX, int NU, int G>
__device__ __forceinline__ void group_emit(
    const RicArgs& a, const Group<G>& grp, const GMats<NX, NU, G>& m, int b,
    int iters, const float (&ac)[NX / G][NX], const float (&kc)[NX / G][NU],
    const float (&pc)[NX / G][NX], const float (&Ra)[NU]) {
  constexpr int C = NX / G, LU = GShape<NX, NU, G>::LU;
  float kn[C][NU], L[NU][NU];
  group_gain<NX, NU, G>(grp, m, Ra, ac, kn, L);   // B'P to m.BtPc, factor
  // Quu_inv = (R1 + B'PB)^-1, column q by lane q mod G.
  for (int q = grp.g; q < NU; q += G) {
    float e[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) e[i] = i == q ? 1.0f : 0.0f;
    chol_solve_reg<NU>(L, e);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      a.Quu_inv[(size_t)b * NU * NU + i * NU + q] = e[i];
  }
  float t[C][NX];
  group_closed_loop<NX, NU, G>(m, ac, kc, t);   // A - B K by columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = grp.g + G * c;
    float* amb = a.AmBKt + (size_t)b * NX * NX + j * NX;   // row j
    float* pin = a.Pinf + (size_t)b * NX * NX + j * NX;    // row j = column j
#pragma unroll
    for (int k = 0; k < NX; ++k) { amb[k] = t[c][k]; pin[k] = pc[c][k]; }
    // coeff(j, i) = K(i, j) R1(i) - sum_k AmBKt(j, k) (PB)(k, i), with PB's
    // row k = B'P's column k (P exactly symmetric).
    float co[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) co[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      float v[NU];
      ld_row<NU>(v, m.BtPc + k * LU);
#pragma unroll
      for (int i = 0; i < NU; ++i) co[i] = fmaf(t[c][k], v[i], co[i]);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      a.coeff[(size_t)b * NX * NU + j * NU + i] = kc[c][i] * Ra[i] - co[i];
      a.Kinf[(size_t)b * NU * NX + i * NX + j] = kc[c][i];
    }
  }
  if (grp.g == 0) a.iters[b] = iters;
}

extern __shared__ float4 ric_smem4[];

template <int NX, int NU, int G>
__global__ void __launch_bounds__(RIC_THREADS)
group_fixed_point_kernel(RicArgs a) {
  using S = GShape<NX, NU, G>;
  constexpr int C = S::C, LX = S::LX;
  const Group<G> grp;
  const int slot = threadIdx.x / G;
  const int b = blockIdx.x * (RIC_THREADS / G) + slot;
  if (b >= a.Bn) return;   // whole groups only
  const GMats<NX, NU, G> m(
      reinterpret_cast<float*>(ric_smem4) + slot * S::stride(false), false);
  float ac[C][NX], Qa[C], Ra[NU];
  group_load<NX, NU, G>(a, grp, m, b, ac, Qa, Ra);
  float kc[C][NU], pc[C][NX];
  const float rho = __ldg(a.rho + b);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = grp.g + G * c;
#pragma unroll
    for (int r = 0; r < NX; ++r)
      pc[c][r] = a.P0 != nullptr
          ? __ldg(a.P0 + (size_t)b * NX * NX + r * NX + j)
          : (r == j ? rho : 0.0f);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      kc[c][i] = a.K0 != nullptr
          ? __ldg(a.K0 + (size_t)b * NU * NX + i * NX + j) : 0.0f;
    st_row<NX>(m.Pc + j * LX, pc[c]);
  }
  grp.sync();

  int it = 0;
  while (it < a.max_iters) {
    float kn[C][NU], L[NU][NU];
    group_gain<NX, NU, G>(grp, m, Ra, ac, kn, L);
    float t1[C][NX], t2[C][NX];
    group_closed_loop<NX, NU, G>(m, ac, kn, t1);      // A - B Kn
    cols_times<NX, C, LX>(t2, m.Pc, t1);              // P (A - B Kn)
    cols_t_times<NX, C, LX>(pc, m.Ac, t2);            // A' P (A - B Kn)
    const float delta = group_delta<NX, NU, G>(grp, kn, kc);
    group_symmetrise<NX, NU, G, true>(grp, m, pc, Qa);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < NU; ++i) kc[c][i] = kn[c][i];
    ++it;
    if (!(delta >= a.tol)) break;   // converged, or a non-finite step
  }
  group_emit<NX, NU, G>(a, grp, m, b, it, ac, kc, pc, Ra);
}

template <int NX, int NU, int G>
__global__ void __launch_bounds__(RIC_THREADS)
group_newton_kernel(RicArgs a) {
  using S = GShape<NX, NU, G>;
  constexpr int C = S::C, LX = S::LX, LU = S::LU;
  const Group<G> grp;
  const int slot = threadIdx.x / G;
  const int b = blockIdx.x * (RIC_THREADS / G) + slot;
  if (b >= a.Bn) return;
  const GMats<NX, NU, G> m(
      reinterpret_cast<float*>(ric_smem4) + slot * S::stride(true), true);
  // The lane's columns of A are read from m.Ac where needed: held across
  // the doubling loop they would spill.
  float Qa[C], Ra[NU];
  {
    float ac[C][NX];
    group_load<NX, NU, G>(a, grp, m, b, ac, Qa, Ra);
  }
  auto own_cols_of_A = [&](float (&ac)[C][NX]) {
#pragma unroll
    for (int c = 0; c < C; ++c) ld_row<NX>(ac[c], m.Ac + (grp.g + G * c) * LX);
  };
  float kc[C][NU], pc[C][NX];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < NU; ++i)
      kc[c][i] = __ldg(a.K0 + (size_t)b * NU * NX + i * NX + grp.g + G * c);
    st_row<NU>(m.Kc + (grp.g + G * c) * LU, kc[c]);
  }
  grp.sync();

  int it = 0;
  while (it < a.max_iters) {
    // W = Q1 + K' R1 K, symmetrised, is the Stein sum's start S.
    {
      float n1[C][NU];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < NU; ++i) n1[c][i] = Ra[i] * kc[c][i];
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        float k[NU];
        ld_row<NU>(k, m.Kc + r * LU);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < NU; ++i) acc = fmaf(k[i], n1[c][i], acc);
          pc[c][r] = acc;
        }
      }
    }
    group_symmetrise<NX, NU, G, true>(grp, m, pc, Qa);   // S in m.Pc
    {
      float mj[C][NX];
      {
        float ac[C][NX];
        own_cols_of_A(ac);
        group_closed_loop<NX, NU, G>(m, ac, kc, mj);     // M_0 = A - B K
      }
#pragma unroll
      for (int c = 0; c < C; ++c) st_row<NX>(m.Mc + (grp.g + G * c) * LX, mj[c]);
      grp.sync();
      // Doubling: S += Mj' S Mj; Mj = Mj Mj.
      for (int jd = 0; jd < a.inner_iters; ++jd) {
        float t2[C][NX];
        cols_times<NX, C, LX>(t2, m.Pc, mj);             // S Mj
        cols_t_times<NX, C, LX, true>(pc, m.Mc, t2);     // S += Mj' S Mj
        cols_times<NX, C, LX>(t2, m.Mc, mj);             // Mj Mj
        grp.sync();   // every read of S and Mj is done
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = grp.g + G * c;
          st_row<NX>(m.Pc + j * LX, pc[c]);
          st_row<NX>(m.Mc + j * LX, t2[c]);
#pragma unroll
          for (int r = 0; r < NX; ++r) mj[c][r] = t2[c][r];
        }
        grp.sync();
      }
    }
    group_symmetrise<NX, NU, G, false>(grp, m, pc, Qa);   // P = sym(S)
    float kn[C][NU], L[NU][NU];
    {
      float ac[C][NX];
      own_cols_of_A(ac);
      group_gain<NX, NU, G>(grp, m, Ra, ac, kn, L);
    }
    const float delta = group_delta<NX, NU, G>(grp, kn, kc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < NU; ++i) kc[c][i] = kn[c][i];
      st_row<NU>(m.Kc + (grp.g + G * c) * LU, kc[c]);
    }
    grp.sync();
    ++it;
    if (!(delta >= a.tol)) break;
  }
  float ac[C][NX];
  own_cols_of_A(ac);
  group_emit<NX, NU, G>(a, grp, m, b, it, ac, kc, pc, Ra);
}

// ========================================================= general design ==

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

// M (n x n) <- 0.5 (M + M') + diag(dg), in place: one lane per entry pair.
__device__ inline void sym_add_diag(float* M, const float* dg, int n,
                                    int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    if (j < i) continue;
    const float half = 0.5f * (M[i * n + j] + M[j * n + i]);
    M[i * n + j] = i == j && dg != nullptr ? half + dg[i] : half;
    M[j * n + i] = M[i * n + j];
  }
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

__global__ void __launch_bounds__(RIC_THREADS)
general_fixed_point_kernel(RicArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
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

__global__ void __launch_bounds__(RIC_THREADS)
general_newton_kernel(RicArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
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

// ==================================================================== plan ==

// The lane-group instantiations: (nx, nu, G). riccati_kernel.py mirrors the
// list (GROUP_SHAPES) and the plan below.
#define ATM_RIC_SHAPES(X) X(12, 4, 4) X(6, 3, 2) X(8, 3, 4) X(6, 8, 2) X(5, 2, 1)

// Bytes of dynamic shared memory of one block, and instances per block:
// the lane-group kernel where one is instantiated, else the general one
// with as many warps (at most 4) as fit `limit` bytes (0 instances: the
// size does not fit).
struct RicPlan {
  int group;       // lanes per instance; 0: the general kernel
  int per_block;   // instances per block
  int smem_bytes;
};

inline RicPlan ric_plan(int nx, int nu, bool newton, int limit) {
#define ATM_RIC_PLAN(NX, NU, G)                                             \
  if (nx == NX && nu == NU)                                                 \
    return {G, RIC_THREADS / G,                                             \
            RIC_THREADS / G * GShape<NX, NU, G>::stride(newton) * 4};
  ATM_RIC_SHAPES(ATM_RIC_PLAN)
#undef ATM_RIC_PLAN
  const int per_warp = warp_floats(nx, nu) * 4;
  int warps = RIC_THREADS / 32;
  while (warps > 0 && warps * per_warp > limit) --warps;
  return {0, warps, warps * per_warp};
}

template <typename K>
static int launch_with(K kernel, const RicArgs& a, const RicPlan& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.Bn + p.per_block - 1) / p.per_block;
  const int threads = p.group ? RIC_THREADS : 32 * p.per_block;
  kernel<<<blocks, threads, p.smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch(const RicArgs& a, bool newton, int smem_bytes, int limit,
                  cudaStream_t stream) {
  if (a.Bn <= 0 || a.nx < 1 || a.nu < 1 || a.max_iters < 1) return -1;
  const RicPlan p = ric_plan(a.nx, a.nu, newton, limit);
  if (p.per_block < 1 || p.smem_bytes != smem_bytes) return -1;
#define ATM_RIC_LAUNCH(NX, NU, G)                                           \
  if (p.group && a.nx == NX && a.nu == NU)                                  \
    return newton ? launch_with(group_newton_kernel<NX, NU, G>, a, p, stream) \
                  : launch_with(group_fixed_point_kernel<NX, NU, G>, a, p,  \
                                stream);
  ATM_RIC_SHAPES(ATM_RIC_LAUNCH)
#undef ATM_RIC_LAUNCH
  return newton ? launch_with(general_newton_kernel, a, p, stream)
                : launch_with(general_fixed_point_kernel, a, p, stream);
}

}  // namespace atm

extern "C" {

// Fixed point. P0 and K0 both null (cold: P0 = rho I, K0 = 0) or both given.
// smem_bytes: the caller's count of the plan's bytes (refused if it differs);
// limit: the shared memory a block may take on this device.
int atm_riccati_fixed_point(
    const float* A, const float* B, const float* Q, const float* R,
    const float* rho, const float* P0, const float* K0,
    float* Kinf, float* Pinf, float* Quu_inv, float* AmBKt, float* coeff,
    int* iters, int Bn, int nx, int nu, int max_iters, float tol,
    int smem_bytes, int limit, void* stream) {
  if ((P0 == nullptr) != (K0 == nullptr)) return -1;
  atm::RicArgs a = {A, B, Q, R, rho, P0, K0, Kinf, Pinf, Quu_inv, AmBKt,
                    coeff, iters, Bn, nx, nu, max_iters, 0, tol};
  return atm::launch(a, false, smem_bytes, limit,
                     static_cast<cudaStream_t>(stream));
}

// Newton-Kleinman from the gain K0; max_outer outer steps of inner_iters
// doublings each.
int atm_riccati_newton(
    const float* A, const float* B, const float* Q, const float* R,
    const float* rho, const float* K0,
    float* Kinf, float* Pinf, float* Quu_inv, float* AmBKt, float* coeff,
    int* iters, int Bn, int nx, int nu, int max_outer, int inner_iters,
    float tol, int smem_bytes, int limit, void* stream) {
  if (K0 == nullptr || inner_iters < 0) return -1;
  atm::RicArgs a = {A, B, Q, R, rho, nullptr, K0, Kinf, Pinf, Quu_inv, AmBKt,
                    coeff, iters, Bn, nx, nu, max_outer, inner_iters, tol};
  return atm::launch(a, true, smem_bytes, limit,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
