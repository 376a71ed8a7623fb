// Flash attention, forward (K7), its Hopper form: bfloat16 operands on the
// tensor cores through wgmma, with the Q, K and V tiles brought into shared
// memory by TMA (sm_90a only).  out = softmax(q k^T / sqrt(hd), causal) v
// per (batch, head), with GQA (query head h reads kv head h / (H / KV)),
// never forming the (T, S) score matrix in device memory.
//
// Replaces, beside csrc/flash_attention.cu (the CUDA-core form, which keeps
// float32, float64 and the head dims this form does not take), the TPU
// kernel `flash_attention_pallas` of src/repro/kernels/flashattn/kernel.py
// (:76, pallas_call at :93, body `_flash_kernel` :31-73).  The same
// function under the reference's rules: masked scores are -1e30, the first
// K/V tile always holds column 0 (so the running max is finite), K/V tiles
// above the diagonal are skipped, l = max(l, 1e-30) at the end, the output
// is rounded once to bfloat16, and the GQA head map is h / (H / KV).  It
// differs from the reference in two places:
//   - the scale hd^-0.5 is applied to the float32 scores, not to q before
//     the product (a bfloat16 q * scale would round q: hd^-0.5 is not a
//     power of two); scale * log2(e) is folded into exp2f;
//   - P is rounded to bfloat16 for the product P V, as SDPA's flash path
//     does (that is what puts the product on the tensor cores); the row
//     sum l is taken from the float32 P.
// So the output lies within 3 * 2^-8 * max|v| of the reference's function
// (P's rounding moves o by at most 2^-8 sum_j p_j |v_j| / l <= 2^-8 max|v|,
// and each of the two output roundings by 2^-8 |o|).
//
// Design (FlashAttention-3's forward without ping-pong scheduling): one CTA
// of three warpgroups per (128 query rows, head, batch), heaviest causal
// tiles first.
//   - warpgroup 0 is the producer: it lowers its registers to 24
//     (setmaxnreg) and one thread issues the TMA loads: Q once, then K and
//     V through a ring of 2 stages of BK = 128 keys, each stage behind a
//     full and an empty mbarrier (phase parity tracked per stage);
//   - warpgroups 1 and 2 are consumers of 64 query rows each, raised to
//     240 registers.  Per K/V tile: S = Q K^T by wgmma m64n128k16 with both
//     operands in shared memory (both K-major: hd contiguous, so K needs no
//     transpose); the online softmax on the accumulator fragment (a row is
//     shared by the four threads of a quad: max by two shuffles, the sum
//     per thread, reduced once at the end; masks only on tiles that cross
//     the diagonal or the end of S); P converted to bfloat16 in place (the
//     accumulator layout of S is the register A-fragment layout); O += P V
//     by wgmma with P from registers and V from shared memory, MN-major
//     (hd contiguous) through the transpose bit.  A consumer releases a
//     stage once both of its products have retired (wgmma.wait_group 0);
//     O is rescaled only after the previous P V has retired.
//   - the epilogue divides by max(l, 1e-30), rounds once and stores.
// Tiles are stored as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B: a
// row of hd bfloat16 values is cut into 64-column boxes (a swizzled box is
// at most 128 bytes wide), each box a run of 8-row x 128-byte swizzle
// atoms, and the wgmma descriptors walk the same atoms.  TMA fills rows
// past T or S with zeros; the mask handles col < S, so 128 need not divide
// T or S.
//
// What bounds it on an H100: operations.  Causal attention does
// 4 B H hd T (T + 1) / 2 useful flops for 4 (B T H + B S KV) hd bytes,
// hundreds of flops a byte, against the 989 TFLOP/s bf16 tensor peak.
//
// Shared memory: Q 128 hd + 2 stages x 2 x 128 hd bfloat16 values, 160 KB
// at hd = 128 (one CTA an SM), 80 KB at hd = 64, plus 1 KB of alignment.
// hd = 256 would need 320 KB with this ring and a 128-register O
// accumulator beside S: it stays on the CUDA-core form.  Instantiated for
// bfloat16 at hd in {64, 128}, causal and not.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_flash_sm90 {

constexpr int BQ = 128;            // query rows a CTA (two consumers of 64)
constexpr int BK = 128;            // keys a K/V tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBox = 64;           // bfloat16 columns a swizzled box
constexpr int kRowBytes = kBox * 2;          // bytes of a box row
constexpr uint32_t kAtomBytes = 8 * kRowBytes;  // 8-row x 128-byte atom
constexpr float kMasked = -1e30f;  // the reference's masked score

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------
// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------
// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64 x 128, f32) (+)= A(64 x 16) B(16 x 128), A and B K-major in shared
// memory; d is overwritten where accumulate == 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24), REPRO_D8(32),
        REPRO_D8(40), REPRO_D8(48), REPRO_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 128, f32) += A(64 x 16, bfloat16 registers) B(16 x 128), B
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24), REPRO_D8(32),
        REPRO_D8(40), REPRO_D8(48), REPRO_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with N = 64 (the output of hd = 64)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_D8

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return static_cast<uint32_t>(BQ) * HD * 2;  // BQ == BK
}

template <int HD>
__host__ __device__ constexpr uint32_t smem_bytes() {
  return tile_bytes<HD>() * (1 + 2 * kStages) + 1024;  // + alignment slack
}

// Q, K, V as 4-d tensor maps (hd, heads, length, batch) in bfloat16, boxes
// (64, 1, 128, 1); o (B, T, H, HD) contiguous.
template <int HD, bool Causal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int Tq, int S, int H,
                      int KV, float scale_log2) {
  constexpr int NH = HD / kBox;                  // boxes across a row
  constexpr uint32_t kTile = tile_bytes<HD>();   // Q, K or V tile
  constexpr uint32_t kHalf = BQ * kRowBytes;     // one box column of a tile
  constexpr int ND = HD / 2;                     // O floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];

  // 1024-byte aligned tiles: Q, then per stage K and V
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + kTile;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);  // + 8 * stage

  // heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int kend = Causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kTile);
#pragma unroll
      for (int c = 0; c < NH; ++c)
        tma_load(sQ + c * kHalf, &tq, bar_q, c * kBox, h, q0, b);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages)  // the consumers released this stage's last use
          mbar_wait(bar_empty + 8 * st, ((kt / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t sK = sKV + st * 2 * kTile, sV = sK + kTile;
        mbar_expect_tx(full, 2 * kTile);
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          tma_load(sK + c * kHalf, &tk, full, c * kBox, kvh, kt * BK, b);
          tma_load(sV + c * kHalf, &tv, full, c * kBox, kvh, kt * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t4 = lane % 4;
    // this warp's 16 rows of S and O; this thread's: row0 and row0 + 8
    const int row_lo = q0 + cw * 64 + warp * 16;
    const int row0 = row_lo + g;
    // the consumer's 64 rows of Q (both boxes shift by the same rows)
    const uint32_t sQw = sQ + cw * 64 * kRowBytes;

    float acc[ND], s[64];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n] = 0.0f;
#pragma unroll
    for (int n = 0; n < 64; ++n) s[n] = 0.0f;

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < ntiles; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
      const uint32_t sK = sKV + st * 2 * kTile, sV = sK + kTile;

      // S = Q K^T: K-major both, k16 steps of 32 bytes inside a box row
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        const uint32_t off = (kc / 4) * kHalf + (kc % 4) * 32;
        wgmma_ss_n128(s, desc_sw128(sQw + off, 16, kAtomBytes),
                      desc_sw128(sK + off, 16, kAtomBytes), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[j * 4 + i * 2 + c]: row row0 + 8 i, column k0 + 8 j + 2 t4 + c
      const int k0 = kt * BK;
      const bool edge = k0 + BK > S || (Causal && k0 + BK - 1 > row_lo);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = k0 + 8 * j + 2 * t4 + c;
              if (col >= S || (Causal && col > row0 + 8 * i))
                s[j * 4 + i * 2 + c] = kMasked;
            }
      }

      // online softmax: the quad of threads sharing a row reduces its max
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(s[j * 4 + i * 2], s[j * 4 + i * 2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f((m[i] - m_new) * scale_log2);
        const float mb = m_new * scale_log2;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(fmaf(s[j * 4 + i * 2 + c], scale_log2, -mb));
            s[j * 4 + i * 2 + c] = p;
            sum += p;
          }
        l[i] = l[i] * alpha + sum;  // this thread's columns; quad-summed last
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[j * 4 + i * 2 + c] *= alpha;
      }

      // P in bfloat16 as the A fragments of the 8 k16 steps of P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(s[kc * 8 + 2 * r], s[kc * 8 + 2 * r + 1]);

      // O += P V: V MN-major (hd contiguous); a k16 step is 16 key rows,
      // LBO steps between the 64-column boxes, SBO between 8-row atoms
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<HD>(acc, pa[kc],
                     desc_sw128(sV + kc * 16 * kRowBytes, kHalf, kAtomBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * st);  // both products of this stage retired
    }

    // epilogue: o = acc / max(l, 1e-30), rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int t = row0 + 8 * i;
      if (t >= Tq) continue;
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Tq + t) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[j * 4 + i * 2] * inv,
                                  acc[j * 4 + i * 2 + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, len, heads, hd) contiguous bfloat16 as dims (hd, heads, len, B),
// boxes of (64, 1, 128, 1), 128-byte swizzle, rows past len read as zeros
int tensor_map(CUtensorMap* map, const void* ptr, int hd, int heads, int len,
               int B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {kBox, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int HD, bool Causal>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KV, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = tensor_map(&tq, q, HD, H, Tq, B);
  if (rc == 0) rc = tensor_map(&tk, k, HD, KV, S, B);
  if (rc == 0) rc = tensor_map(&tv, v, HD, KV, S, B);
  if (rc != 0) return rc;
  constexpr size_t bytes = smem_bytes<HD>();
  auto kern = flash_sm90_kernel<HD, Causal>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Tq, S, H, KV,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int by_causal(int causal, const void* q, const void* k, const void* v,
              void* o, int B, int Tq, int S, int H, int KV, float scale,
              cudaStream_t s) {
  return causal ? launch<HD, true>(q, k, v, o, B, Tq, S, H, KV, scale, s)
                : launch<HD, false>(q, k, v, o, B, Tq, S, H, KV, scale, s);
}

}  // namespace repro_flash_sm90

// C interface, bound with ctypes by src/repro_torch/kernels/flashattn/
// kernel.py; the argument list of flash_attention_launch
// (csrc/flash_attention.cu).  dtype_id: 1 (bfloat16) only.  hd: 64 or 128.
// q (B, T, H, hd), k and v (B, S, KV, hd), o (B, T, H, hd), contiguous and
// 16-byte aligned, H a multiple of KV.  Returns cudaGetLastError() after
// the launch (or the error of cudaFuncSetAttribute), -1 for another dtype
// id, -2 for another hd, -3 where a tensor map cannot be encoded, -4 where
// the driver has no cuTensorMapEncodeTiled.  Launches on `stream` and does
// not synchronise.
extern "C" int flash_attention_sm90_launch(int dtype_id, int hd, int causal,
                                           const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int T, int S, int H, int KV,
                                           float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_id != 1) return -1;
  switch (hd) {
    case 64:
      return repro_flash_sm90::by_causal<64>(causal, q, k, v, o, B, T, S, H,
                                             KV, scale, s);
    case 128:
      return repro_flash_sm90::by_causal<128>(causal, q, k, v, o, B, T, S, H,
                                              KV, scale, s);
  }
  return -2;
}
