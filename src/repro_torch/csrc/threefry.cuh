// Counter-based normals for the SDE kernels: Threefry-2x32 (20 rounds) and
// Box-Muller, shared by the fixed-dt kernel (sde_ensemble.cu) and the
// adaptive kernel on the virtual Brownian tree (sde_adaptive_ensemble.cu).
//
// This is src/repro/kernels/rng.py for one thread: `threefry2x32` (:24),
// `_to_unit` (:44), and the two streams keyed by the second key word,
// `counter_normals_threefry` (:136, key 0x243F6A88, counter
// step * 0x9E3779B9 + row) and `bridge_normals` (:49, key 0x85A308D3,
// counter node * 0x9E3779B9 + row), with the lane as the second counter
// word.  Native uint32 arithmetic, rotations as funnel shifts.  The normals
// are computed in float whatever the state type, as the reference computes
// them in float32: (bits + 0.5) * 2^-32 in (0, 1], then
// sqrt(-2 log u1) * cos(2 pi u2), every product and sum rounded on its own
// (the _rn intrinsics).  No --use_fast_math: the approximate intrinsics
// would move every normal.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_rng {

constexpr uint32_t kStreamKey = 0x243F6A88u;
constexpr uint32_t kBridgeKey = 0x85A308D3u;
constexpr uint32_t kStepStride = 0x9E3779B9u;
constexpr uint32_t kParity = 0x1BD11BDAu;
// 2*pi rounded to float, the constant the reference multiplies by
constexpr float kTwoPiF32 = 6.28318548202514648f;
constexpr float kTwoM32 = 2.3283064365386963e-10f;  // 2^-32

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = c0 + ks0, x1 = c1 + ks1;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks1; x1 += ks2 + 1u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += ks2; x1 += ks0 + 2u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks0; x1 += ks1 + 3u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += ks1; x1 += ks2 + 4u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += ks2; x1 += ks0 + 5u;
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return __fmul_rn(__fadd_rn(__uint2float_rn(bits), 0.5f), kTwoM32);
}

__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float u1 = to_unit(a), u2 = to_unit(b);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(kTwoPiF32, u2)));
}

// The fixed-dt stream: N(0, 1) of (seed; step, row, lane).
__device__ __forceinline__ float counter_normal(uint32_t seed, uint32_t step,
                                                uint32_t row, uint32_t lane) {
  uint32_t a, b;
  threefry2x32(seed, kStreamKey, step * kStepStride + row, lane, a, b);
  return box_muller(a, b);
}

// The virtual Brownian tree's stream: N(0, 1) of (seed; node, row, lane).
__device__ __forceinline__ float bridge_normal(uint32_t seed, uint32_t node,
                                               uint32_t row, uint32_t lane) {
  uint32_t a, b;
  threefry2x32(seed, kBridgeKey, node * kStepStride + row, lane, a, b);
  return box_muller(a, b);
}

}  // namespace repro_rng
