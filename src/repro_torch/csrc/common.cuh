// Shared helpers of the SnapMLA Hopper kernels: storage formats, the exact
// casts of repro_torch/core/quant.py, cp.async copies, the widening of a
// packed 32-bit word, warp reductions, and the register-held row of the
// token-preparation kernels (D, #9).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, never
// --use_fast_math: expf/logf and IEEE division keep every kernel bit-equal
// to its plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace snap {

constexpr float kEps = 1e-12f;     // quant.EPS
constexpr float kNegInf = -1e30f;  // finite -inf sentinel of the reference kernel

// Storage formats, as the Python wrappers pass them.
enum Fmt : int { kFp8 = 0, kInt8 = 1, kNone = 2 };

template <int F> struct Format;

template <> struct Format<kFp8> {
  using T = uint8_t;                         // torch.float8_e4m3fn bytes
  static constexpr float kQmax = 448.0f;
  static __device__ __forceinline__ float widen(T v) {
    __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v), __NV_E4M3);
    return __half2float(__half(h));
  }
  // clip to +-448, then round to nearest even (torch's and ml_dtypes' cast)
  static __device__ __forceinline__ T cast(float x) {
    x = x < -kQmax ? -kQmax : (x > kQmax ? kQmax : x);
    return static_cast<T>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
  }
};

template <> struct Format<kInt8> {
  using T = int8_t;
  static constexpr float kQmax = 127.0f;
  static __device__ __forceinline__ float widen(T v) { return static_cast<float>(v); }
  // round half to even (jnp.round / torch.round), then clip to +-127
  static __device__ __forceinline__ T cast(float x) {
    float r = rintf(x);
    r = r < -kQmax ? -kQmax : (r > kQmax ? kQmax : r);
    return static_cast<T>(r);
  }
};

template <> struct Format<kNone> {
  using T = __nv_bfloat16;                   // unquantized bf16 latent
  static constexpr float kQmax = 1.0f;
  static __device__ __forceinline__ float widen(T v) { return __bfloat162float(v); }
};

// max(amax, EPS) / qmax exactly as the reference's compiled form computes it:
// a product with the float32 reciprocal of the constant qmax.
template <int F>
__device__ __forceinline__ float dynamic_scale(float amax) {
  constexpr float inv = 1.0f / Format<F>::kQmax;
  return fmaxf(amax, kEps) * inv;
}

// --- AMLA power-of-two grid (port of repro/kernels/mla_decode/amla.py) ---
// f32 ln 2 and 1/ln 2 (== f32 log2 e): log2(x) is computed as the reference's
// compiled form does it, log(x) * f32(1/ln 2).
constexpr float kLn2 = 0x1.62e43p-1f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, the smallest normal

// Subnormal -> signed zero: the reference's compiled arithmetic flushes
// subnormal inputs and results of the exp2_mul fallback (XLA on the CPU, and
// the TPU), so the port does it explicitly.
__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < kTiny ? copysignf(0.f, x) : x;
}

// 2^k exactly, 0 below 2^-126 and +inf above 2^127 (the reference's exp2 of
// an integer at the ends of the range).
__device__ __forceinline__ float pow2i(int k) {
  if (k < -126) return 0.f;
  if (k > 127) return __int_as_float(0x7f800000);
  return __int_as_float((k + 127) << 23);
}

// x * 2^k by an integer add on the exponent field where input and result
// are normal; otherwise the flushed multiply by 2^k (amla.exp2_mul).
__device__ __forceinline__ float exp2_mul(float x, int k) {
  const int bits = __float_as_int(x);
  const int biased = (bits >> 23) & 0xff;
  const int shifted = biased + k;
  if (biased > 0 && shifted > 0 && shifted < 255)
    return __int_as_float(bits + static_cast<int>(static_cast<unsigned>(k) << 23));
  return flush_subnormal(__fmul_rn(flush_subnormal(x), pow2i(k)));
}

// The power-of-two P scale's exponent, ceil(log2(max(amax, EPS) / qmax))
// (amla.quantize_block_pow2), as a float holding an integer.
template <int F>
__device__ __forceinline__ float pow2_scale_exponent(float amax) {
  return ceilf(__fmul_rn(logf(dynamic_scale<F>(amax)), kLog2e));
}

// --- asynchronous copies into shared memory (sm_80 and later) ---
// cp.async of N (4, 8 or 16) bytes from global into shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N)
                 : "memory");
}

// cp.async of N (4, 8 or 16) bytes that reads nothing and zero-fills the
// destination when ok is false (source size 0)
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
                 "r"(ok ? N : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (<= 3) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The values packed in one 32-bit word of a stored row (an MLA content row,
// a GQA K or V row), widened to float64 (exactly: every storage format is a
// subset of float64).
template <int F> struct Unpack;

template <> struct Unpack<kFp8> {
  static constexpr int kPerWord = 4;
  static __device__ __forceinline__ void run(uint32_t v, double (&out)[4]) {
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(v & 0xffffu), __NV_E4M3)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(v >> 16), __NV_E4M3)));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  }
};

template <> struct Unpack<kInt8> {
  static constexpr int kPerWord = 4;
  static __device__ __forceinline__ void run(uint32_t v, double (&out)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = static_cast<int8_t>((v >> (8 * e)) & 0xffu);
  }
};

template <> struct Unpack<kNone> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ void run(uint32_t v, double (&out)[2]) {
    out[0] = bf16_lo(v); out[1] = bf16_hi(v);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- token preparation (D, #9): one row of [content | rope] by one warp ---
// The MLA configs' widths (configs/mla_7b.py, configs/deepseek_v3_mla.py),
// the compile-time instantiation of q_quant.cu and k_append.cu.
constexpr int kTokenDc = 512;
constexpr int kTokenDr = 64;

// One row held in registers at compile-time widths: lane l holds content
// values [l * kC, (l + 1) * kC) and lanes 0 .. DR / 4 - 1 four rope values
// each. Every read is a 16-byte load, all issued before any is used; the
// quotients are taken from the registers, so the row is read once. The
// pointers must be 16-byte aligned.
template <int DC, int DR>
struct TokenRow {
  static_assert(DC % 512 == 0, "a lane's content codes go out as 16-byte stores");
  static_assert(DR % 4 == 0 && DR <= 128, "one float4 of rope per lane");
  static constexpr int kC = DC / 32;
  static constexpr int kRopeLanes = DR / 4;
  float c[kC];
  float4 r;

  __device__ __forceinline__ void load(const float* __restrict__ content,
                                       const float* __restrict__ rope, int lane) {
    const float4* src = reinterpret_cast<const float4*>(content + lane * kC);
#pragma unroll
    for (int j = 0; j < kC / 4; ++j) {
      const float4 v = src[j];
      c[4 * j] = v.x; c[4 * j + 1] = v.y; c[4 * j + 2] = v.z; c[4 * j + 3] = v.w;
    }
    r = lane < kRopeLanes ? reinterpret_cast<const float4*>(rope)[lane]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // sigma = max(max|content|, EPS) * f32(1/qmax) over the whole row
  template <int F>
  __device__ __forceinline__ float scale() const {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) amax = fmaxf(amax, fabsf(c[i]));
    return dynamic_scale<F>(warp_max(amax));
  }

  // cast(content / sigma), this lane's kC codes as kC / 16 16-byte stores
  // into the row's codes at dst
  template <int F>
  __device__ __forceinline__ void store_content(typename Format<F>::T* __restrict__ dst,
                                                float sig, int lane) const {
    uint4* out = reinterpret_cast<uint4*>(dst + lane * kC);
#pragma unroll
    for (int s = 0; s < kC / 16; ++s) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint8_t code = static_cast<uint8_t>(Format<F>::cast(c[16 * s + 4 * k + e] / sig));
          w[k] |= static_cast<uint32_t>(code) << (8 * e);
        }
      }
      out[s] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  // this lane's rope / sigma in float32 (meaningful on lanes < kRopeLanes)
  __device__ __forceinline__ float4 rope_over(float sig) const {
    return make_float4(r.x / sig, r.y / sig, r.z / sig, r.w / sig);
  }
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// four bf16 (round to nearest even), lowest address in the lowest half
__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  return make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                    bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}

// true when every pointer is 16-byte aligned
__host__ __forceinline__ bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace snap
