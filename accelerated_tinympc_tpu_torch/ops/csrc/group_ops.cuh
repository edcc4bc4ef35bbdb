// Group-of-lanes helpers shared by the hetero and stream kernels: a group of
// G = pow2 lanes (4..32) owns one instance, lane i holds component i of each
// vector; products broadcast the vector by __shfl_sync within the group.

#pragma once

#include <cuda_runtime.h>

namespace atm_group {

constexpr unsigned FULL = 0xffffffffu;

// Max that keeps a NaN (fmaxf drops it, and a NaN residual must not pass a
// tolerance test).
__device__ inline float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Box clip min(max(x, lo), hi) that keeps a NaN x.
__device__ inline float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

template <int G>
__device__ inline float bcast(float v, int k) {
  return __shfl_sync(FULL, v, k, G);
}

template <int G>
__device__ inline float gsum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, G);
  return v;
}

template <int G>
__device__ inline float gmax(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(FULL, v, o, G));
  return v;
}

// sum_k row[k] * vec_k, vec_k broadcast from lane k of the group; two
// accumulators halve the dependent chain. The loop runs over all G lanes
// without a branch, so the compiler can issue every shuffle ahead of the
// FMAs: rows are zero past the plant's size and the lanes past it hold 0, so
// the extra terms add exact zeros.
template <int G>
__device__ inline float dot(const float (&row)[G], float vec) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int k = 0; k < G; k += 2) {
    a0 = fmaf(row[k], bcast<G>(vec, k), a0);
    a1 = fmaf(row[k + 1], bcast<G>(vec, k + 1), a1);
  }
  return a0 + a1;
}

// Cones c0 .. c0+nc-1 in order on this knot's slack (one component per
// lane): the exact SOC projection of solver/cones.py, with ball and axis
// membership from the lane's bits and mu/shift from shared memory.
template <int G>
__device__ inline float cones(float w, int c0, int nc, unsigned bbits,
                              unsigned abits, const float* cp) {
  for (int c = c0; c < c0 + nc; ++c) {
    const bool inb = (bbits >> c) & 1u, isax = (abits >> c) & 1u;
    const float mu = cp[2 * c], sh = cp[2 * c + 1];
    const float bw = inb ? w : 0.0f;
    const float a2 = gsum<G>(bw * bw);
    const float s = gsum<G>(isax ? w : 0.0f) + sh;
    const float a = sqrtf(a2);
    const bool inside = a <= mu * s;
    const bool polar = mu * a <= -s;
    const float cc = (mu * a + s) / (mu * mu + 1.0f);
    const float safe_a = a2 == 0.0f ? a + 1.0f : a;
    const float scale = inside ? 1.0f : (polar ? 0.0f : mu * cc / safe_a);
    const float s_new = (inside ? s : (polar ? 0.0f : cc)) - sh;
    w = inb ? w * scale : (isax ? s_new : w);
  }
  return w;
}

}  // namespace atm_group
