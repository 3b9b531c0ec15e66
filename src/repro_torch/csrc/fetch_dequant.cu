// Fused fetch + dequantise of the FP8 latent cache for Hopper (sm_90a): the
// prefix read of chunked prefill.
//
// Replaces (the reference JAX package, Pallas on TPU):
//   #11 paged fetch-dequant    repro/kernels/quantize/fetch_dequant.py:
//        paged_fetch_dequant_pallas (_paged_fetch_dequant_body, full mode, and
//        _bounded_paged_fetch_body, bounded by chunk_start)
//   #10 contiguous fetch       fetch_dequant.py: fetch_dequant_pallas
//        (_fetch_dequant_kernel) — the same kernel with page_table == nullptr:
//        page j of row b is block b*P + j of the [B, P*page, .] cache, as the
//        reference's own paged body is its contiguous body (fetch_dequant.py:39-42)
//
// Out [B, P*page, d_c + d_r] bf16, in each row's logical order: token t of
// logical page j is bf16(content * sigma) | bf16(rope * sigma) — one float32
// multiply (__fmul_rn, never contracted) then a round-to-nearest-even cast,
// the plain version's arithmetic. With chunk_start, page j of row b is live
// iff j*page < chunk_start[b]; a dead page is written as zeros and its pool
// page is never read (the reference's output contract, fetch_dequant.py:62-64).
//
// Design. One block of 256 threads per (logical page, row). Each thread walks
// (token, 16-value unit) pairs, token-major, so neighbouring threads touch
// neighbouring bytes: a content unit is one 16-byte load of fp8/int8 (two of
// bf16) and two 16-byte stores; a rope unit is 8 bf16, one 16-byte load and
// one store. Every live pool byte is read once and every output byte written
// once. Bound on the H100: (live pages * page * (d_c + 2 d_r + 4) bytes read
// + B*P*page*(d_c + d_r)*2 bytes written) / 3.35 TB/s — a pure copy with a
// multiply, memory-bound. Left for later: a TMA bulk copy of each page.
#include "common.cuh"

namespace snap {

constexpr int kFetchThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// Value k of 16 stored values packed in 32-bit words, widened to float.
template <int F>
__device__ __forceinline__ float value(const uint32_t* w, int k) {
  if constexpr (F == kNone) {
    return __uint_as_float(((w[k / 2] >> (16 * (k % 2))) & 0xffffu) << 16);
  } else {
    const uint32_t byte = (w[k / 4] >> (8 * (k % 4))) & 0xffu;
    return Format<F>::widen(static_cast<typename Format<F>::T>(byte));
  }
}

template <int F>
__global__ void __launch_bounds__(kFetchThreads)
fetch_dequant_kernel(const typename Format<F>::T* __restrict__ content,
                     const __nv_bfloat16* __restrict__ rope, const float* __restrict__ scale,
                     const int* __restrict__ page_table, const int* __restrict__ chunk_start,
                     __nv_bfloat16* __restrict__ out, int P, int page, int d_c, int d_r) {
  using T = typename Format<F>::T;
  const int j = blockIdx.x, b = blockIdx.y;
  const int d = d_c + d_r;
  const size_t out0 = (static_cast<size_t>(b) * P + j) * page * d;  // first output element
  if (chunk_start != nullptr && j * page >= chunk_start[b]) {  // dead page: zeros, no reads
    uint4* dst = reinterpret_cast<uint4*>(out + out0);
    for (int i = threadIdx.x; i < page * d / 8; i += kFetchThreads) dst[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const size_t pid = page_table != nullptr
                         ? static_cast<size_t>(page_table[static_cast<size_t>(b) * P + j])
                         : static_cast<size_t>(b) * P + j;
  const int cu = d_c / 16, ru = d_r / 8, units = cu + ru;
  for (int i = threadIdx.x; i < page * units; i += kFetchThreads) {
    const int t = i / units, u = i - t * units;
    const float s = scale[pid * page + t];
    __nv_bfloat16* row = out + out0 + static_cast<size_t>(t) * d;
    if (u < cu) {
      constexpr int kWords = 4 * sizeof(T);  // 16 values of T in 32-bit words
      uint32_t in[kWords];
      const uint4* src = reinterpret_cast<const uint4*>(content + (pid * page + t) * d_c + u * 16);
#pragma unroll
      for (int k = 0; k < kWords / 4; ++k) {
        const uint4 v = src[k];
        in[4 * k] = v.x; in[4 * k + 1] = v.y; in[4 * k + 2] = v.z; in[4 * k + 3] = v.w;
      }
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = pack_bf16x2(__fmul_rn(value<F>(in, 2 * k), s), __fmul_rn(value<F>(in, 2 * k + 1), s));
      uint4* dst = reinterpret_cast<uint4*>(row + u * 16);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
      const int r = u - cu;
      const uint4 v = *reinterpret_cast<const uint4*>(rope + (pid * page + t) * d_r + r * 8);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack_bf16x2(__fmul_rn(__uint_as_float(in[k] << 16), s),
                           __fmul_rn(__uint_as_float(in[k] & 0xffff0000u), s));
      *reinterpret_cast<uint4*>(row + d_c + r * 8) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int F>
static cudaError_t launch_fetch(const void* content, const void* rope, const float* scale,
                                const int* page_table, const int* chunk_start, void* out, int B,
                                int P, int page, int d_c, int d_r, cudaStream_t stream) {
  const dim3 grid(P, B);
  fetch_dequant_kernel<F><<<grid, kFetchThreads, 0, stream>>>(
      static_cast<const typename Format<F>::T*>(content),
      static_cast<const __nv_bfloat16*>(rope), scale, page_table, chunk_start,
      static_cast<__nv_bfloat16*>(out), P, page, d_c, d_r);
  return cudaGetLastError();
}

}  // namespace snap

// page_table == nullptr: contiguous cache [B, P*page, .] (#10); chunk_start ==
// nullptr: full mode (every table entry read).
extern "C" int snapmla_fetch_dequant(int fmt, const void* content, const void* rope,
                                     const void* scale, const void* page_table,
                                     const void* chunk_start, void* out, int B, int P, int page,
                                     int d_c, int d_r, void* stream) {
  using namespace snap;
  if (B < 1 || P < 1 || page < 1 || d_c % 16 || d_r % 8 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* cs = static_cast<const int*>(chunk_start);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kFp8: err = launch_fetch<kFp8>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, st); break;
    case kInt8: err = launch_fetch<kInt8>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, st); break;
    case kNone: err = launch_fetch<kNone>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
