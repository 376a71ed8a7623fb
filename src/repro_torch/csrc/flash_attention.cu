// Flash attention, forward (K7), written by hand for Hopper (sm_90a):
// out = softmax(q k^T / sqrt(hd), causal) v per (batch, head), with GQA
// (query head h reads kv head h / (H / KV)), never forming the (T, S)
// score matrix in device memory.
//
// Replaces the TPU kernel `flash_attention_pallas` of
// src/repro/kernels/flashattn/kernel.py (:76, pallas_call at :93, body
// `_flash_kernel` :31-73).  The same function, the same rules: q is cast
// to float and multiplied by scale = hd^-0.5 before the products, K and V
// are read as float, masked scores are -1e30, the online softmax carries
// (m, l, acc) in float, l = max(l, 1e-30) at the end, and the output is
// written in the input type (float, bfloat16 or double; a double input is
// computed in float, as the reference's astype(float32) does).  The tile
// sizes are this kernel's own (64 x 64), not the reference's VMEM blocks,
// so sums are taken in another order; causal tiles past the diagonal are
// skipped as the reference skips its K/V blocks.
//
// Design (one CTA of 256 threads per (q-tile of 64 rows, head, batch)):
//   - the CTA's q rows are staged once into shared memory as float, scaled;
//   - K/V tiles of 64 keys are staged in turn into shared memory as float;
//   - thread (rg, cg) = (tid / 16, tid % 16) owns rows 4 rg .. 4 rg + 3 of
//     the tile, the score columns cg + 16 j (j < 4) and, of the output,
//     the head dimensions cg * DV + 16 DV m + e;
//   - scores, the running max and sum, and the accumulators live in
//     registers; a row's max and sum are reduced over the 16 threads that
//     share it (one half-warp) by warp shuffles;
//   - P goes through shared memory (the K tile's buffer, once the scores
//     are taken) to the threads that own its row's output;
//   - every product is an FMA on the CUDA cores, in float.
//
// What bounds it on an H100: operations.  Causal attention does
// 4 B H hd T (T + 1) / 2 useful flops for 4 (B T H + B S KV) hd bytes in
// bf16 (q, k, v read once, o written once), hundreds of flops a byte; on the tensor cores the bound is the
// 989 TFLOP/s bf16 peak, on the CUDA cores this design reaches at most the
// 67 TFLOP/s FP32 peak.  Moving the two products onto wgmma with TMA-fed
// tiles is the next step; this kernel is the simple, exact form first.
//
// Shared memory: BQ (hd + 4) + max(BK (hd + 4), BK (BQ + 4)) + BK hd
// floats: 100,352 bytes at hd = 128 (two CTAs an SM), 198,656 at hd = 256
// (one), above 48 KB only after cudaFuncSetAttribute
// (MaxDynamicSharedMemorySize).
// Instantiated for hd in {16, 32, 64, 128, 256} and float, bfloat16 and
// double inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_flash {

constexpr int kThreads = 256;
constexpr int BQ = 64;             // query rows a CTA
constexpr int BK = 64;             // keys a tile
constexpr int kPad = 4;            // floats of padding per staged row
constexpr int PS = BQ + kPad;      // row stride of P (stored [key][row])
constexpr float kMasked = -1e30f;  // the reference's masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(double x) {
  return __double2float_rn(x);
}
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ double from_float<double>(float x) {
  return static_cast<double>(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// DV consecutive floats from shared memory (DV = 4, 2 or 1)
template <int DV>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (DV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (DV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

// the K tile's buffer, which also holds P
template <int HD>
__host__ __device__ constexpr int kp_floats() {
  return BK * (HD + kPad) > BK * PS ? BK * (HD + kPad) : BK * PS;
}

template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return BQ * (HD + kPad) + kp_floats<HD>() + BK * HD;
}

// q (B, T, H, HD), k/v (B, S, KV, HD), o (B, T, H, HD), all contiguous.
template <typename T, int HD, bool Causal>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int S,
                 int H, int KV, float scale) {
  constexpr int QS = HD + kPad;             // row stride of Qs and Ks
  constexpr int DV = HD >= 64 ? 4 : HD / 16;  // dims a thread reads at once
  constexpr int NM = HD / (16 * DV);          // DV-chunks a thread owns
  constexpr int ND = DV * NM;                 // output dims a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BQ][QS], q * scale
  float* Ks = Qs + BQ * QS;          // [BK][QS]; then P as [BK][PS]
  float* Vs = Ks + kp_floats<HD>();  // [BK][HD]
  float* Ps = Ks;

  // heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const size_t q_row = static_cast<size_t>(H) * HD;      // stride of t in q
  const size_t kv_row = static_cast<size_t>(KV) * HD;    // stride of s in k
  const T* qb = q + (static_cast<size_t>(b) * Tq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int t = q0 + r;
    Qs[r * QS + d] = t < Tq ? to_float(qb[t * q_row + d]) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.0f;
  }

  const int kend = Causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P and V are consumed
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int s = k0 + c;
      const bool in = s < S;
      Ks[c * QS + d] = in ? to_float(kb[s * kv_row + d]) : 0.0f;
      Vs[c * HD + d] = in ? to_float(vb[s * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4 rg + i, columns cg + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_vec<4>(Qs + (rg * 4 + i) * QS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_vec<4>(Ks + (cg + 16 * j) * QS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qv[i][e], kv[j][e],
                                                      sc[i][j]);
    }

    // mask, online softmax update (each row reduced over its half-warp)
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        const bool ok = col < S && (!Causal || col <= row);
        sc[i][j] = ok ? sc[i][j] : kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] *= alpha[i];
    }

    __syncthreads();  // every warp is done reading Ks: P takes its place
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (cg + 16 * j) * PS + rg * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncwarp();  // a row's P is written and read by its own half-warp

    // acc[i] += P[row i, c] * V[c, dims]
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[4];
      load_vec<4>(Ps + c * PS + rg * 4, pv);
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        float vv[DV];
        load_vec<DV>(Vs + c * HD + mm * 16 * DV + cg * DV, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DV; ++e)
            acc[i][mm * DV + e] = fmaf(pv[i], vv[e], acc[i][mm * DV + e]);
      }
    }
  }

  T* ob = o + (static_cast<size_t>(b) * Tq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    if (t >= Tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int e = 0; e < DV; ++e)
        ob[t * q_row + mm * 16 * DV + cg * DV + e] =
            from_float<T>(acc[i][mm * DV + e] * inv);
  }
}

template <typename T, int HD, bool Causal>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KV, float scale, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<HD>();
  auto kern = flash_kernel<T, HD, Causal>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_causal(int causal, const void* q, const void* k, const void* v,
              void* o, int B, int Tq, int S, int H, int KV, float scale,
              cudaStream_t s) {
  return causal ? launch<T, HD, true>(q, k, v, o, B, Tq, S, H, KV, scale, s)
                : launch<T, HD, false>(q, k, v, o, B, Tq, S, H, KV, scale, s);
}

template <typename T>
int by_hd(int hd, int causal, const void* q, const void* k, const void* v,
          void* o, int B, int Tq, int S, int H, int KV, float scale,
          cudaStream_t s) {
  switch (hd) {
    case 16: return by_causal<T, 16>(causal, q, k, v, o, B, Tq, S, H, KV, scale, s);
    case 32: return by_causal<T, 32>(causal, q, k, v, o, B, Tq, S, H, KV, scale, s);
    case 64: return by_causal<T, 64>(causal, q, k, v, o, B, Tq, S, H, KV, scale, s);
    case 128: return by_causal<T, 128>(causal, q, k, v, o, B, Tq, S, H, KV, scale, s);
    case 256: return by_causal<T, 256>(causal, q, k, v, o, B, Tq, S, H, KV, scale, s);
  }
  return -2;
}

}  // namespace repro_flash

// C interface, bound with ctypes by src/repro_torch/kernels/flashattn/
// kernel.py.  dtype_id: 0 float32, 1 bfloat16, 2 float64.  hd: 16, 32, 64,
// 128 or 256.  q (B, T, H, hd), k and v (B, S, KV, hd), o (B, T, H, hd),
// contiguous, H a multiple of KV.  Returns cudaGetLastError() after the
// launch (or the error of cudaFuncSetAttribute), -1 for an unknown dtype
// id, -2 for an unsupported hd.  Launches on `stream` and does not
// synchronise.
extern "C" int flash_attention_launch(int dtype_id, int hd, int causal,
                                      const void* q, const void* k,
                                      const void* v, void* o, int B, int T,
                                      int S, int H, int KV, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_id) {
    case 0:
      return repro_flash::by_hd<float>(hd, causal, q, k, v, o, B, T, S, H,
                                       KV, scale, s);
    case 1:
      return repro_flash::by_hd<__nv_bfloat16>(hd, causal, q, k, v, o, B, T,
                                               S, H, KV, scale, s);
    case 2:
      return repro_flash::by_hd<double>(hd, causal, q, k, v, o, B, T, S, H,
                                        KV, scale, s);
  }
  return -1;
}
