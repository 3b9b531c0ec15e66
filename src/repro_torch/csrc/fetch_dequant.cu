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
// Bound on the H100: (live pages * page * (d_c + 2 d_r + 4) bytes read +
// B*P*page*(d_c + d_r)*2 bytes written) / 3.35 TB/s — a copy with a multiply,
// memory-bound, and mostly writes (bf16 out of fp8 in).
//
// Design. A grid of token slices: each block of kFetchWarps warps takes
// kFetchWarps * tpw consecutive tokens of one (logical page, row), each warp
// tpw of them (grid (ceil(page / (kFetchWarps * tpw)), P, B)); the wrapper
// picks tpw in 1 .. kMaxTokensPerWarp, the most tokens per warp whose grid
// still covers the SMs (kernels/quantize/fetch_dequant.py::fetch_geometry).
// So the engine's shape (B = 1, 8 pages of 128 tokens) runs 256 blocks, not
// one block per page (8 blocks on 132 SMs), and 32k tokens per row run 4
// tokens per warp. A token's d_c + d_r values are output chunks of 8 values
// (16 bytes of bf16); lane l takes chunks l, l + 32, l + 64 of each of its
// warp's tokens, so a warp's store instruction writes 512 contiguous bytes
// and its content loads read 256 (fp8 / int8: 8 bytes a lane). Per warp:
// lane i < tpw loads token i's scale (one load instruction for all), which
// the warp reads by shuffles; every content and rope load of the warp's
// tokens is issued before the first conversion (up to kMaxTokensPerWarp x
// kChunkSlots 16-byte loads in flight per lane); then each chunk is scaled,
// rounded and stored. A dead page's slice is zeroed with the same 16-byte
// stores and reads nothing. A slice past the page's last token (a page that
// is not a multiple of the slice) copies only the page's tokens.
#include "common.cuh"

namespace snap {

constexpr int kFetchWarps = 4;         // warps per block
constexpr int kFetchThreads = 32 * kFetchWarps;
constexpr int kMaxTokensPerWarp = 4;   // the most tokens a warp has in flight
constexpr int kChunkSlots = 3;         // output chunks per lane per pass: 96 per token

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// The 8 stored values of output chunk c of pool row r: content values
// 8c .. 8c + 7 (c < cc; 8 bytes of fp8 / int8 in .x, .y, or 16 of bf16) or
// rope values 8(c - cc) .. (16 bytes of bf16).
template <int F>
__device__ __forceinline__ uint4 load_chunk(const typename Format<F>::T* __restrict__ content,
                                            const __nv_bfloat16* __restrict__ rope, size_t r,
                                            int c, int cc, int d_c, int d_r) {
  if (c < cc) {
    const auto* p = content + r * d_c + 8 * c;
    if constexpr (F == kNone) {
      return *reinterpret_cast<const uint4*>(p);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      return make_uint4(v.x, v.y, 0u, 0u);
    }
  }
  return *reinterpret_cast<const uint4*>(rope + r * d_r + 8 * (c - cc));
}

// bf16_rn(value * s) of a chunk's 8 values, packed in pairs: 8-bit content
// values (bytes of v.x, v.y) or bf16 values (halves of v.x .. v.w).
template <int F>
__device__ __forceinline__ uint4 dequant_chunk(uint4 v, bool bytes, float s) {
  uint32_t w[4];
  if constexpr (F != kNone) {
    if (bytes) {
      const uint32_t in[2] = {v.x, v.y};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * k + e;
          const uint32_t byte = (in[i / 4] >> (8 * (i % 4))) & 0xffu;
          x[e] = __fmul_rn(Format<F>::widen(static_cast<typename Format<F>::T>(byte)), s);
        }
        w[k] = pack_bf16x2(x[0], x[1]);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = pack_bf16x2(__fmul_rn(bf16_lo(in[k]), s), __fmul_rn(bf16_hi(in[k]), s));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int F>
__global__ void __launch_bounds__(kFetchThreads)
fetch_dequant_kernel(const typename Format<F>::T* __restrict__ content,
                     const __nv_bfloat16* __restrict__ rope, const float* __restrict__ scale,
                     const int* __restrict__ page_table, const int* __restrict__ chunk_start,
                     __nv_bfloat16* __restrict__ out, int P, int page, int d_c, int d_r,
                     int tpw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.y, b = blockIdx.z;
  const int t0 = (blockIdx.x * kFetchWarps + warp) * tpw;   // the warp's first token of the page
  if (t0 >= page) return;                                   // the slice ends with the page
  const int n = min(tpw, page - t0);                        // the warp's tokens
  const int chunks = (d_c + d_r) / 8, cc = d_c / 8;
  uint4* dst = reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * P + j) * page + t0) *
                                                  (d_c + d_r));
  if (chunk_start != nullptr && j * page >= chunk_start[b]) {  // dead page: zeros, no reads
    for (int i = lane; i < n * chunks; i += 32) dst[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const size_t pid = page_table != nullptr
                         ? static_cast<size_t>(page_table[static_cast<size_t>(b) * P + j])
                         : static_cast<size_t>(b) * P + j;
  const size_t r0 = pid * page + t0;                        // the warp's first pool row
  const float s_lane = lane < n ? scale[r0 + lane] : 0.f;
  float s[kMaxTokensPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxTokensPerWarp; ++i) s[i] = __shfl_sync(0xffffffffu, s_lane, i);
  for (int c0 = lane; c0 < chunks; c0 += 32 * kChunkSlots) {
    uint4 v[kMaxTokensPerWarp][kChunkSlots];
#pragma unroll
    for (int i = 0; i < kMaxTokensPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kChunkSlots; ++k) {
        const int c = c0 + 32 * k;
        if (i < n && c < chunks) v[i][k] = load_chunk<F>(content, rope, r0 + i, c, cc, d_c, d_r);
      }
#pragma unroll
    for (int i = 0; i < kMaxTokensPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kChunkSlots; ++k) {
        const int c = c0 + 32 * k;
        if (i < n && c < chunks) dst[i * chunks + c] = dequant_chunk<F>(v[i][k], c < cc, s[i]);
      }
  }
}

template <int F>
static cudaError_t launch_fetch(const void* content, const void* rope, const float* scale,
                                const int* page_table, const int* chunk_start, void* out, int B,
                                int P, int page, int d_c, int d_r, int tpw, cudaStream_t stream) {
  const int slice = kFetchWarps * tpw;
  const dim3 grid((page + slice - 1) / slice, P, B);
  fetch_dequant_kernel<F><<<grid, kFetchThreads, 0, stream>>>(
      static_cast<const typename Format<F>::T*>(content),
      static_cast<const __nv_bfloat16*>(rope), scale, page_table, chunk_start,
      static_cast<__nv_bfloat16*>(out), P, page, d_c, d_r, tpw);
  return cudaGetLastError();
}

}  // namespace snap

// page_table == nullptr: contiguous cache [B, P*page, .] (#10); chunk_start ==
// nullptr: full mode (every table entry read); tpw: tokens per warp, 1 ..
// kMaxTokensPerWarp (the wrapper's fetch_geometry).
extern "C" int snapmla_fetch_dequant(int fmt, const void* content, const void* rope,
                                     const void* scale, const void* page_table,
                                     const void* chunk_start, void* out, int B, int P, int page,
                                     int d_c, int d_r, int tpw, void* stream) {
  using namespace snap;
  if (B < 1 || P < 1 || page < 1 || d_c % 16 || d_r % 8 || B > 65535 || P > 65535 || tpw < 1 ||
      tpw > kMaxTokensPerWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* cs = static_cast<const int*>(chunk_start);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kFp8:
      err = launch_fetch<kFp8>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, tpw, st);
      break;
    case kInt8:
      err = launch_fetch<kInt8>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, tpw, st);
      break;
    case kNone:
      err = launch_fetch<kNone>(content, rope, sc, pt, cs, out, B, P, page, d_c, d_r, tpw, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
