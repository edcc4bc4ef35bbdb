// Long-horizon ADMM kernels for Hopper (sm_90a), FP32, one plant shared by
// the whole batch (K9, K10):
//
//   shared_stream_kernel<NX, NU, false>  replaces accelerated_tinympc_tpu/
//                                        ops/stream_admm.py _kernel (fixed
//                                        iterations; its _make_streamer
//                                        phases)
//   shared_stream_kernel<NX, NU, true>   replaces stream_admm.py
//                                        _kernel_adaptive (per-instance
//                                        early exit)
//
// What bounds it: memory traffic, then the latency of the knot chain. At N
// in the hundreds to thousands one instance's iterates (d, y, z: (N-1) nu;
// g, v: N nx floats) take ~100 KB at nx=8, nu=3, N=1024, so a batch of
// thousands lives in device memory and every iteration streams it: the
// forward sweep reads d, y, g (and the old z, v where residuals are taken)
// and writes y, z, g, v; the backward sweep reads y, z, g, v and qc and
// writes d. Within an instance the knots form a chain (x_{i+1} from u_i from
// x_i; p_i from p_{i+1}), so the only parallelism is across instances.
//
// Design.
//  * One thread per instance, one warp per block: lane s is slot s, which
//    holds an instance until it is done and then takes the next one from a
//    work counter (zeroed by the wrapper before each launch; claims are
//    aggregated per warp, so slots that start together hold consecutive
//    instances). A slot's iteration count is its own, so in the adaptive
//    kernel a converged instance leaves its slot at the next iteration
//    boundary and no lane waits for the slowest instance of its warp once
//    the batch exceeds the slots in flight.
//  * The iterates are knot-major and instance-innermost in device memory
//    (d as (N-1, nu, B), g as (N, nx, B); the wrapper transposes the carry
//    in and the results out), so the 32 slots' rows of one knot component
//    are 32 consecutive floats: every load and store of a sweep coalesces
//    while the slots hold consecutive instances.
//  * Knot data comes off the chain: each lane keeps its own ring of the
//    next kb knots in shared memory, filled by cp.async (one group per
//    knot, kb - 1 knots ahead of the one computed), and stores its results
//    straight to device memory. A lane reads only what it copied itself,
//    so the sweeps need no barrier.
//  * The plant (A, AmBKt, B, Kinf, their transposes and Quu_inv, rows padded
//    to float4), pterm, uniform bounds and the cone table are staged once per
//    block in shared memory; products read the rows by broadcast float4
//    loads and keep the vectors (x, u, p) in registers, so a knot step is a
//    few FMA chains of depth nx + nu at most, with no shuffles. NX, NU are
//    template parameters for the one shape of atm_shared_shape (fully
//    unrolled, the plant's rows in registers); every other size runs the same body with NX = NU = 0, its
//    vectors in the slot's column of shared memory and its loops at run
//    time, as far as shared memory takes the plant and the ring. qc and
//    per-knot bound schedules are read by broadcast from device memory.
//  * Slacks in place except on checks: a check iteration writes the new
//    slacks to zs/vs and keeps z/v; an instance that converges there keeps
//    the old ones (pre-save Z, V) and skips the backward pass (pre-backward
//    D); one that goes on reads them back in the backward sweep and writes
//    them to z/v. U and X of a converging check are recomputed in the
//    slot's next sweep, from x0 and the D it kept (the rollout reads
//    nothing else, so the values are those of that iteration, bit for
//    bit); at the iteration cap they are written during the last forward
//    sweep. A slot's arithmetic depends on its instance alone: a permuted
//    batch, a compacted relaunch (stream_cascade_solve) and any kb give the
//    same bits.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream, does not synchronise, allocates nothing (the work counter is the
// caller's) and returns cudaGetLastError(), or -1 for arguments out of
// range or a shared-memory size that disagrees with the wrapper's.

#include <cuda_runtime.h>

namespace atm_shared {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOTS = 32;  // slots per block: one warp

struct Args {
  const float *x0, *A, *Bm, *K, *Quu, *M;
  const float *umin, *umax, *xmin, *xmax, *qc, *pterm, *rho;
  // knot-major, instance-innermost: (N-1, nu, Bn) and (N, nx, Bn)
  float *U, *X, *d, *y, *g, *z, *v, *zs, *vs;
  float* stats;       // (Bn, 8)
  const float* ctab;  // cone table (rows of 2 + max(nx, nu)) or null
  int* counter;       // work counter, 0 at launch
  int nc_u, nc_x, bk;  // cones; bk: bounds per knot (else one row)
  int Bn, nx, nu, N, max_iter, check_every, en_ib, en_sb, kb;
  float pri_tol, dua_tol;
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// Offsets, in floats, of the block's dynamic shared memory. The Python
// wrapper mirrors `total` (ops/stream_admm.py shared_smem_bytes) and the
// entry refuses a launch when the two disagree.
struct Layout {
  int A, M, Bm, Kt, K, Bt, Q;     // plant rows, padded to float4
  int pt, ul, uh, xl, xh, ct;     // pterm, uniform bounds, cone table
  int scr;                        // vectors of the run-time-size body:
                                  // x, v (nx), u, z (nu), then p or the
                                  // rollout's x (nx), r, w (nu) per slot
  int ring, rw;                   // kb knots of rw floats per slot
  int oD, oY, oZ, oG, oV;         // inside a knot's ring entry
  int total;
};

__host__ __device__ inline Layout make_layout(int nx, int nu, int kb, int nc,
                                              int general) {
  Layout L;
  const int px = r4(nx), pu = r4(nu), tw = nx > nu ? nx : nu;
  int o = 0;
  L.A = o;   o += nx * px;
  L.M = o;   o += nx * px;
  L.Bm = o;  o += nx * pu;
  L.Kt = o;  o += nx * pu;
  L.K = o;   o += nu * px;
  L.Bt = o;  o += nu * px;
  L.Q = o;   o += nu * pu;
  L.pt = o;  o += px;
  L.ul = o;  o += pu;
  L.uh = o;  o += pu;
  L.xl = o;  o += px;
  L.xh = o;  o += px;
  L.ct = o;  o += r4(nc * (2 + tw));
  L.scr = o; o += general ? SLOTS * (3 * nx + 4 * nu) : 0;
  L.oD = 0;
  L.oY = nu;
  L.oZ = 2 * nu;
  L.oG = 3 * nu;
  L.oV = 3 * nu + nx;
  L.rw = 3 * nu + 2 * nx;
  L.ring = o; o += kb * L.rw * SLOTS;
  L.total = o;
  return L;
}

// ---------------------------------------------------------------- helpers --

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;  // keeps a NaN
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;               // keeps a NaN x
  return x > hi ? hi : x;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's most recent groups are pending.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A slot's vector: registers for a compile-time length, else the lane's
// column of the scratch area (element k at p[k * SLOTS]).
template <int N>
struct Vec {
  float v[N];
  __device__ __forceinline__ float& operator[](int k) { return v[k]; }
};
template <>
struct Vec<0> {
  float* p;
  __device__ __forceinline__ float& operator[](int k) { return p[k * SLOTS]; }
};
template <int N>
__device__ __forceinline__ void bind(Vec<N>&, float*) {}
__device__ __forceinline__ void bind(Vec<0>& v, float* p) { v.p = p; }

// sum_k row[k] v[k], k < n (n = NN when NN > 0), even and odd k in two
// accumulators: half the dependent chain. Rows are float4-aligned and zero
// padded.
template <int NN, class V>
__device__ __forceinline__ float dotrow(const float* row, V& v, int n) {
  float a0 = 0.0f, a1 = 0.0f;
  if constexpr (NN > 0) {
#pragma unroll
    for (int k = 0; k < NN; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(row + k);
      a0 = fmaf(w.x, v[k], a0);
      if (k + 1 < NN) a1 = fmaf(w.y, v[k + 1], a1);
      if (k + 2 < NN) a0 = fmaf(w.z, v[k + 2], a0);
      if (k + 3 < NN) a1 = fmaf(w.w, v[k + 3], a1);
    }
  } else {
    for (int k = 0; k + 1 < n; k += 2) {
      a0 = fmaf(row[k], v[k], a0);
      a1 = fmaf(row[k + 1], v[k + 1], a1);
    }
    if (n & 1) a0 = fmaf(row[n - 1], v[n - 1], a0);
  }
  return a0 + a1;
}

// R rows of C plant entries for the products of one sweep: in registers
// (REG, loaded once per sweep), else read in place from shared memory
// (rows ld floats apart, float4-aligned and zero padded). dot(r, v, n) is
// dotrow's sum, in dotrow's order, either way.
template <int R, int C, bool REG>
struct Rows {
  float m[R][C];
  __device__ __forceinline__ void load(const float* s, int ld) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) m[r][c] = s[r * ld + c];
  }
  template <class V>
  __device__ __forceinline__ float dot(int r, V& v, int) const {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k & 1) a1 = fmaf(m[r][k], v[k], a1);
      else a0 = fmaf(m[r][k], v[k], a0);
    }
    return a0 + a1;
  }
};
template <int R, int C>
struct Rows<R, C, false> {
  const float* s;
  int ld;
  __device__ __forceinline__ void load(const float* s_, int ld_) {
    s = s_;
    ld = ld_;
  }
  template <class V>
  __device__ __forceinline__ float dot(int r, V& v, int n) const {
    return dotrow<C>(s + r * ld, v, n);
  }
};

// Cones c0 .. c1-1 in order on one knot's slack w (n components): the exact
// SOC projection of solver/cones.py. A cone's table row holds mu, shift and
// each component's role (1 in the ball, 2 the axis, 0 neither).
template <int NN, class V>
__device__ __forceinline__ void cones(V& w, int n, int c0, int c1,
                                      const float* tab, int tw) {
  for (int c = c0; c < c1; ++c) {
    const float* row = tab + c * (2 + tw);
    const float mu = row[0], sh = row[1];
    float a2 = 0.0f, sx = 0.0f;
#pragma unroll
    for (int k = 0; k < (NN ? NN : n); ++k) {
      const float role = row[2 + k];
      if (role == 1.0f) a2 = fmaf(w[k], w[k], a2);
      if (role == 2.0f) sx = w[k];
    }
    const float s = sx + sh;
    const float an = sqrtf(a2);
    const bool inside = an <= mu * s;
    const bool polar = mu * an <= -s;
    const float cc = (mu * an + s) / (mu * mu + 1.0f);
    const float safe_a = a2 == 0.0f ? an + 1.0f : an;
    const float scale = inside ? 1.0f : (polar ? 0.0f : mu * cc / safe_a);
    const float s_new = (inside ? s : (polar ? 0.0f : cc)) - sh;
#pragma unroll
    for (int k = 0; k < (NN ? NN : n); ++k) {
      const float role = row[2 + k];
      w[k] = role == 1.0f ? w[k] * scale : (role == 2.0f ? s_new : w[k]);
    }
  }
}

// One knot's ring entry of this lane (element k at e[k * SLOTS]).
struct Entry {
  float* e;
  __device__ __forceinline__ float& operator[](int k) { return e[k * SLOTS]; }
};

// The forward sweep's copies of knot i into this lane's entry: d of input
// knot i (i < m) for every active slot; y and g for a full iteration; the old
// z and v where residuals are taken. o = b + (knot, component) * Bn.
__device__ __forceinline__ void fetch_forward(const Args& a, const Layout& L,
                                              float* e, int i, int b,
                                              bool full, bool res) {
  const int nx = a.nx, nu = a.nu, Bn = a.Bn;
  if (i < a.N - 1) {
    const size_t o = (size_t)i * nu * Bn + b;
    for (int q = 0; q < nu; ++q) {
      const size_t oq = o + (size_t)q * Bn;
      cp4(e + (L.oD + q) * SLOTS, a.d + oq);
      if (full) cp4(e + (L.oY + q) * SLOTS, a.y + oq);
      if (res) cp4(e + (L.oZ + q) * SLOTS, a.z + oq);
    }
  }
  if (full) {
    const size_t o = (size_t)i * nx * Bn + b;
    for (int c = 0; c < nx; ++c) {
      const size_t oc = o + (size_t)c * Bn;
      cp4(e + (L.oG + c) * SLOTS, a.g + oc);
      if (res) cp4(e + (L.oV + c) * SLOTS, a.v + oc);
    }
  }
}

// The backward sweep's copies of knot i: y and the current z of input knot
// i (i < m), g and the current v of state knot i (the new slacks sit in
// zs/vs after a check).
__device__ __forceinline__ void fetch_backward(const Args& a, const Layout& L,
                                               float* e, int i, int b,
                                               bool scr) {
  const int nx = a.nx, nu = a.nu, Bn = a.Bn;
  if (i < a.N - 1) {
    const size_t o = (size_t)i * nu * Bn + b;
    const float* zsrc = scr ? a.zs : a.z;
    for (int q = 0; q < nu; ++q) {
      const size_t oq = o + (size_t)q * Bn;
      cp4(e + (L.oY + q) * SLOTS, a.y + oq);
      cp4(e + (L.oZ + q) * SLOTS, zsrc + oq);
    }
  }
  const size_t o = (size_t)i * nx * Bn + b;
  const float* vsrc = scr ? a.vs : a.v;
  for (int c = 0; c < nx; ++c) {
    const size_t oc = o + (size_t)c * Bn;
    cp4(e + (L.oG + c) * SLOTS, a.g + oc);
    cp4(e + (L.oV + c) * SLOTS, vsrc + oc);
  }
}

// ----------------------------------------------------------------- kernel --

template <int NX, int NU, bool ADAPTIVE>
__global__ void __launch_bounds__(SLOTS) shared_stream_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x;
  const int nx = NX ? NX : a.nx, nu = NX ? NU : a.nu;
  const int N = a.N, m = N - 1, kb = a.kb, Bn = a.Bn;
  const int px = r4(nx), pu = r4(nu), tw = nx > nu ? nx : nu;
  const int nc = a.nc_u + a.nc_x;
  const Layout L = make_layout(nx, nu, kb, nc, NX == 0);
  constexpr bool REG = NX > 0;

  // Stage the plant, padded rows zeroed, and the uniform vectors.
  for (int i = lane; i < L.ring; i += SLOTS) sm[i] = 0.0f;
  __syncwarp();
  for (int i = lane; i < nx * nx; i += SLOTS) {
    const int r = i / nx, c = i - r * nx;
    sm[L.A + r * px + c] = a.A[i];
    sm[L.M + r * px + c] = a.M[i];
  }
  for (int i = lane; i < nx * nu; i += SLOTS) {
    const int r = i / nu, c = i - r * nu;   // B (nx, nu)
    sm[L.Bm + r * pu + c] = a.Bm[i];
    sm[L.Bt + c * px + r] = a.Bm[i];
    const int rk = i / nx, ck = i - rk * nx;  // K (nu, nx)
    sm[L.K + rk * px + ck] = a.K[i];
    sm[L.Kt + ck * pu + rk] = a.K[i];
  }
  for (int i = lane; i < nu * nu; i += SLOTS)
    sm[L.Q + (i / nu) * pu + i % nu] = a.Quu[i];
  for (int i = lane; i < nx; i += SLOTS) {
    sm[L.pt + i] = a.pterm[i];
    if (!a.bk) { sm[L.xl + i] = a.xmin[i]; sm[L.xh + i] = a.xmax[i]; }
  }
  if (!a.bk)
    for (int i = lane; i < nu; i += SLOTS) {
      sm[L.ul + i] = a.umin[i];
      sm[L.uh + i] = a.umax[i];
    }
  for (int i = lane; i < nc * (2 + tw); i += SLOTS) sm[L.ct + i] = a.ctab[i];
  const float rho = *a.rho;
  __syncwarp();

  const float* sA = sm + L.A;
  const float* sM = sm + L.M;
  const float* sB = sm + L.Bm;
  const float* sKt = sm + L.Kt;
  const float* sK = sm + L.K;
  const float* sBt = sm + L.Bt;
  const float* sQ = sm + L.Q;
  const float* tab = sm + L.ct;
  float* scr = sm + L.scr + lane;       // this lane's scratch column
  float* ring = sm + L.ring + lane;     // this lane's ring: entry t at
  const int ew = L.rw * SLOTS;          //   ring + t * ew

  // Slot state; the first claim takes 32 consecutive instances.
  int base = 0;
  if (lane == 0) base = atomicAdd(a.counter, SLOTS);
  int b = __shfl_sync(FULL, base, 0) + lane;
  if (b >= Bn) b = -1;
  int it = 0;              // iterations done
  bool emit_next = false;  // converged: recompute U/X, then retire
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float iters = 0.0f, solved = 0.0f;

  while (__any_sync(FULL, b >= 0)) {
    const int kc = it + 1;
    const bool act = b >= 0;
    const bool full = act && !emit_next;
    const bool chk = ADAPTIVE && full && kc % a.check_every == 0;
    const bool res = ADAPTIVE ? chk : (full && kc == a.max_iter);
    const bool emit = act && (emit_next || kc == a.max_iter);
    // residual maxima: primal and dual, state and input knots
    float rpx = 0.0f, rdx = 0.0f, rpu = 0.0f, rdu = 0.0f;
    bool newly = false;
    if (act) {
      // ---------------------------------------------------- forward sweep
      Vec<NX> x, vn;
      Vec<NU> u, zn;
      bind(x, scr);
      bind(vn, scr + SLOTS * nx);
      bind(u, scr + SLOTS * 2 * nx);
      bind(zn, scr + SLOTS * (2 * nx + nu));
      for (int c = 0; c < nx; ++c) x[c] = a.x0[(size_t)b * nx + c];
      // The plant's rows for the chain in registers where the shape is
      // compiled; the loads of a knot's ring entry are
      // barriers to the compiler, so rows in shared memory would be read
      // again at every knot.
      Rows<NU, NX, REG> Kr;
      Rows<NX, NU, REG> Br;
      Rows<NX, NX, REG> Ar;
      Kr.load(sK, px);
      Br.load(sB, pu);
      Ar.load(sA, px);
      float* zdst = chk ? a.zs : a.z;
      float* vdst = chk ? a.vs : a.v;
      for (int t = 0; t < kb - 1; ++t) {   // the first kb - 1 knots ahead
        if (t <= m) fetch_forward(a, L, ring + t * ew, t, b, full, res);
        cp_commit();
      }
      for (int i = 0; i <= m; ++i) {
        const int ia = i + kb - 1;         // the knot kb - 1 ahead
        if (ia <= m)
          fetch_forward(a, L, ring + (ia % kb) * ew, ia, b, full, res);
        cp_commit();
        cp_wait(kb - 1);                   // knot i has arrived
        Entry e{ring + (i % kb) * ew};
        // State knot i: slack v = clip(x + g), cones, dual g, residuals.
        const size_t ox = (size_t)i * nx * Bn + b;
        if (full) {
          const float* xl = a.bk ? a.xmin + (size_t)i * nx : sm + L.xl;
          const float* xh = a.bk ? a.xmax + (size_t)i * nx : sm + L.xh;
#pragma unroll
          for (int c = 0; c < nx; ++c) vn[c] = x[c] + e[L.oG + c];
#pragma unroll
          for (int c = 0; c < nx; ++c)
            if (a.en_sb) vn[c] = clip(vn[c], xl[c], xh[c]);
          if (a.nc_x) cones<NX>(vn, nx, a.nc_u, nc, tab, tw);
#pragma unroll
          for (int c = 0; c < nx; ++c) {
            if (res) {
              rpx = nanmax(rpx, fabsf(x[c] - vn[c]));
              rdx = nanmax(rdx, fabsf(e[L.oV + c] - vn[c]));
            }
            const size_t oc = ox + (size_t)c * Bn;
            a.g[oc] = (x[c] + e[L.oG + c]) - vn[c];   // dual ascent
            vdst[oc] = vn[c];
          }
        }
        if (emit) {
#pragma unroll
          for (int c = 0; c < nx; ++c) a.X[ox + (size_t)c * Bn] = x[c];
        }
        if (i == m) break;
        // Input knot i: u = -K x - d, slack z = clip(u + y), cones, dual y.
        const size_t ou = (size_t)i * nu * Bn + b;
#pragma unroll
        for (int q = 0; q < nu; ++q)
          u[q] = -Kr.dot(q, x, nx) - e[L.oD + q];
        if (full) {
          const float* ul = a.bk ? a.umin + (size_t)i * nu : sm + L.ul;
          const float* uh = a.bk ? a.umax + (size_t)i * nu : sm + L.uh;
          Vec<NU> su;
          bind(su, scr + SLOTS * (3 * nx + 2 * nu));   // the r column
#pragma unroll
          for (int q = 0; q < nu; ++q) {
            su[q] = u[q] + e[L.oY + q];
            zn[q] = a.en_ib ? clip(su[q], ul[q], uh[q]) : su[q];
          }
          if (a.nc_u) cones<NU>(zn, nu, 0, a.nc_u, tab, tw);
#pragma unroll
          for (int q = 0; q < nu; ++q) {
            if (res) {
              rpu = nanmax(rpu, fabsf(u[q] - zn[q]));
              rdu = nanmax(rdu, fabsf(e[L.oZ + q] - zn[q]));
            }
            const size_t oq = ou + (size_t)q * Bn;
            a.y[oq] = su[q] - zn[q];
            zdst[oq] = zn[q];
          }
        }
        if (emit) {
#pragma unroll
          for (int q = 0; q < nu; ++q) a.U[ou + (size_t)q * Bn] = u[q];
        }
        // x <- A x + B u
        if constexpr (NX > 0) {
          Vec<NX> xn;
#pragma unroll
          for (int c = 0; c < NX; ++c)
            xn[c] = Ar.dot(c, x, nx) + Br.dot(c, u, nu);
#pragma unroll
          for (int c = 0; c < NX; ++c) x[c] = xn[c];
        } else {
          Vec<0> xn;
          bind(xn, scr + SLOTS * (2 * nx + 2 * nu));  // the p column
          for (int c = 0; c < nx; ++c)
            xn[c] = Ar.dot(c, x, nx) + Br.dot(c, u, nu);
          for (int c = 0; c < nx; ++c) x[c] = xn[c];
        }
      }
      cp_wait(0);

      // Convergence at a check (reference admm.cpp:91-109; dual residuals
      // carry rho).
      if (res) {
        r[0] = rpx; r[1] = rho * rdx; r[2] = rpu; r[3] = rho * rdu;
        newly = ADAPTIVE && r[0] < a.pri_tol && r[2] < a.pri_tol &&
                r[1] < a.dua_tol && r[3] < a.dua_tol;
      }

      // --------------------------------------------------- backward sweep
      if (full && !newly) {
        Vec<NX> p;
        Vec<NU> rr, w;
        bind(p, scr + SLOTS * (2 * nx + 2 * nu));
        bind(rr, scr + SLOTS * (3 * nx + 2 * nu));
        bind(w, scr + SLOTS * (3 * nx + 3 * nu));
        Rows<NU, NX, REG> Btr;
        Rows<NU, NU, REG> Qr;
        Rows<NX, NU, REG> Ktr;
        Rows<NX, NX, REG> Mr;
        Btr.load(sBt, px);
        Qr.load(sQ, pu);
        Ktr.load(sKt, pu);
        Mr.load(sM, px);
        for (int t = 0; t < kb - 1; ++t) {
          if (t <= m) fetch_backward(a, L, ring + t * ew, m - t, b, chk);
          cp_commit();
        }
        for (int t = 0; t <= m; ++t) {
          const int i = m - t;
          const int ta = t + kb - 1;
          if (ta <= m)
            fetch_backward(a, L, ring + (ta % kb) * ew, m - ta, b, chk);
          cp_commit();
          cp_wait(kb - 1);
          Entry e{ring + (t % kb) * ew};
          const size_t ox = (size_t)i * nx * Bn + b;
          if (i == m) {  // terminal costate
#pragma unroll
            for (int c = 0; c < nx; ++c) {
              p[c] = sm[L.pt + c] - rho * (e[L.oV + c] - e[L.oG + c]);
              if (chk) a.v[ox + (size_t)c * Bn] = e[L.oV + c];
            }
            continue;
          }
          const size_t ou = (size_t)i * nu * Bn + b;
#pragma unroll
          for (int q = 0; q < nu; ++q) {
            rr[q] = -rho * (e[L.oZ + q] - e[L.oY + q]);
            if (chk) a.z[ou + (size_t)q * Bn] = e[L.oZ + q];
          }
#pragma unroll
          for (int q = 0; q < nu; ++q)
            w[q] = Btr.dot(q, p, nx) + rr[q];
#pragma unroll
          for (int q = 0; q < nu; ++q)
            a.d[ou + (size_t)q * Bn] = Qr.dot(q, w, nu);
          if (chk)
            for (int c = 0; c < nx; ++c)
              a.v[ox + (size_t)c * Bn] = e[L.oV + c];
          if (i > 0) {
            const float* qc = a.qc + (size_t)i * nx;
            if constexpr (NX > 0) {
              Vec<NX> pn;
#pragma unroll
              for (int c = 0; c < NX; ++c)
                pn[c] = (__ldg(qc + c) - rho * (e[L.oV + c] - e[L.oG + c])) +
                        Mr.dot(c, p, nx) - Ktr.dot(c, rr, nu);
#pragma unroll
              for (int c = 0; c < NX; ++c) p[c] = pn[c];
            } else {
              Vec<0> pn;
              bind(pn, scr);   // the x column is free in this sweep
              for (int c = 0; c < nx; ++c)
                pn[c] = (__ldg(qc + c) - rho * (e[L.oV + c] - e[L.oG + c])) +
                        Mr.dot(c, p, nx) - Ktr.dot(c, rr, nu);
              for (int c = 0; c < nx; ++c) p[c] = pn[c];
            }
          }
        }
        cp_wait(0);
      }
    }

    // --------------------------------------------- iteration bookkeeping
    bool retire = false;
    if (act) {
      if (emit_next) {
        retire = true;           // U/X recomputed in this sweep
      } else if (newly) {
        iters = (float)kc;
        solved = 1.0f;
        it = kc;
        if (kc == a.max_iter) retire = true;   // U/X written already
        else emit_next = true;
      } else {
        it = kc;
        if (kc == a.max_iter) {
          iters = (float)a.max_iter;
          retire = true;
        }
      }
      if (retire) {
        float* st = a.stats + (size_t)b * 8;
        st[0] = iters; st[1] = solved;
        st[2] = r[0]; st[3] = r[1]; st[4] = r[2]; st[5] = r[3];
        st[6] = 0.0f; st[7] = 0.0f;
        it = 0;
        emit_next = false;
        r[0] = r[1] = r[2] = r[3] = 0.0f;
        iters = 0.0f;
        solved = 0.0f;
      }
    }
    // Retired slots claim the next instances together (consecutive ones).
    const unsigned want = __ballot_sync(FULL, retire);
    if (want) {
      const int lead = __ffs(want) - 1;
      int first = 0;
      if (lane == lead) first = atomicAdd(a.counter, __popc(want));
      first = __shfl_sync(FULL, first, lead);
      if (retire) {
        b = first + __popc(want & ((1u << lane) - 1u));
        if (b >= Bn) b = -1;
      }
    }
  }
}

// ------------------------------------------------------------------ launch --

// The kernel of one shape and mode, its shared memory set, and the blocks
// the device holds at once (persistent blocks: a launch takes no more).
template <int NX, int NU>
static int resident(bool adaptive, int smem,
                    void (**kernel)(Args), int* blocks) {
  *kernel = adaptive ? shared_stream_kernel<NX, NU, true>
                     : shared_stream_kernel<NX, NU, false>;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel,
                                                      SLOTS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -1;
  *blocks = n_sm * per_sm;
  return 0;
}

static int resident_blocks(int nx, int nu, bool adaptive, int smem,
                           void (**kernel)(Args), int* blocks) {
  return nx == 8 && nu == 3 ? resident<8, 3>(adaptive, smem, kernel, blocks)
                            : resident<0, 0>(adaptive, smem, kernel, blocks);
}

}  // namespace atm_shared

extern "C" {

// Dynamic shared memory of one block (the layout's own count), for the
// wrapper's check. 8/3 (the long-horizon example's plant) has a compiled
// body; every other size runs the run-time one. Keep in step with
// ops/stream_admm.py SHARED_SHAPES.
int atm_shared_smem_bytes(int nx, int nu, int kb, int nc) {
  return atm_shared::make_layout(nx, nu, kb, nc,
                                 !(nx == 8 && nu == 3)).total * 4;
}

// Slots the device holds at once for these sizes (a launch's slots before
// the batch caps them), or a negative CUDA error / -1.
int atm_shared_slots(int nx, int nu, int kb, int nc, int adaptive) {
  void (*kernel)(atm_shared::Args) = nullptr;
  int blocks = 0;
  const int err = atm_shared::resident_blocks(
      nx, nu, adaptive != 0, atm_shared_smem_bytes(nx, nu, kb, nc), &kernel,
      &blocks);
  return err ? (err > 0 ? -err : err) : blocks * atm_shared::SLOTS;
}

// One batched long-horizon solve of one shared plant: A (nx, nx), B (nx,
// nu), K = Kinf (nu, nx), Quu (nu, nu), M = AmBKt (nx, nx), qc (N, nx),
// pterm (nx), rho (1), all in device memory; x0 (Bn, nx). Bounds: one row
// each (bound_knot 0) or a row per knot (1: umin (N-1, nu), xmin (N, nx)).
// The carry d, y, z and U are (N-1, nu, Bn), g, v and X (N, nx, Bn):
// knot-major, instance innermost; the carry is updated in place.
// check_every == 0: fixed max_iter iterations (K9); > 0: the adaptive kernel
// (K10), which needs zs (N-1, nu, Bn) and vs (N, nx, Bn) scratch. cone_tab:
// the device cone table (rows of 2 + max(nx, nu): mu, shift, each
// component's role) of nc_u input and nc_x state cones, or nullptr.
// stats (Bn, 8). kb (1..8): knots each lane keeps in flight; smem_bytes
// must equal atm_shared_smem_bytes.
int atm_shared_stream_solve(
    const float* x0, const float* A, const float* Bm, const float* K,
    const float* Quu, const float* M, const float* umin, const float* umax,
    const float* xmin, const float* xmax, const float* qc,
    const float* pterm, const float* rho,
    float* U, float* X, float* d, float* y, float* g, float* z, float* v,
    float* zs, float* vs, float* stats, const float* cone_tab, int nc_u,
    int nc_x, int* counter, int bound_knot, int Bn, int nx, int nu, int N,
    int max_iter, int check_every, int en_ib, int en_sb, float pri_tol,
    float dua_tol, int kb, int smem_bytes, void* stream) {
  using namespace atm_shared;
  const int nc = nc_u + nc_x;
  if (Bn <= 0 || nx < 1 || nu < 1 || N < 2 || max_iter < 1 ||
      check_every < 0 || bound_knot < 0 || bound_knot > 1 || kb < 1 ||
      nc_u < 0 || nc_x < 0 || (nc > 0) != (cone_tab != nullptr) ||
      counter == nullptr ||
      (check_every > 0 && (zs == nullptr || vs == nullptr)) ||
      kb > 8 || smem_bytes != atm_shared_smem_bytes(nx, nu, kb, nc))
    return -1;
  Args a = {};
  a.x0 = x0; a.A = A; a.Bm = Bm; a.K = K; a.Quu = Quu; a.M = M;
  a.umin = umin; a.umax = umax; a.xmin = xmin; a.xmax = xmax;
  a.qc = qc; a.pterm = pterm; a.rho = rho;
  a.U = U; a.X = X; a.d = d; a.y = y; a.g = g; a.z = z; a.v = v;
  a.zs = zs ? zs : z; a.vs = vs ? vs : v; a.stats = stats;
  a.ctab = cone_tab; a.counter = counter;
  a.nc_u = nc_u; a.nc_x = nc_x; a.bk = bound_knot;
  a.Bn = Bn; a.nx = nx; a.nu = nu; a.N = N; a.max_iter = max_iter;
  a.check_every = check_every; a.en_ib = en_ib; a.en_sb = en_sb; a.kb = kb;
  a.pri_tol = pri_tol; a.dua_tol = dua_tol;
  void (*kernel)(Args) = nullptr;
  int blocks = 0;
  const int err = resident_blocks(nx, nu, check_every > 0, smem_bytes,
                                  &kernel, &blocks);
  if (err) return err;
  const int need = (Bn + SLOTS - 1) / SLOTS;
  kernel<<<blocks < need ? blocks : need, SLOTS, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
