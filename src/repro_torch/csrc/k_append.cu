// Fused-K-Append for Hopper (sm_90a) — kernel #9 of the SnapMLA port.
//
// Replaces repro/kernels/quantize/kernel.py: fused_k_append_pallas
// (_k_append_kernel): for each batch row b, the new latent entry is quantized
// per token and written in place at row seq_lens[b] of the contiguous cache —
// sigma_k = max(max|c_kv|, EPS)/qmax (the product with f32(1/qmax), as the
// reference's compiled form computes it), content = cast(c_kv / sigma_k),
// rope = bf16(k_r / sigma_k) (Eq. 6 domain alignment) and scale = sigma_k. It
// touches only that row; the TPU kernel rewrites the whole page only because
// a Pallas block is a page. The row index is clamped to the last row, as the
// reference's dynamic_update_slice clamps it.
//
// One warp per batch row. Bound on the H100: bytes — it reads (d_c + d_r) * 4
// and writes d_c + 2 * d_r + 4 bytes per row, a few kilobytes per decode step,
// so its time is launch latency. CUDA rather than Triton: the row is one warp
// reduction and one row write with no tiling choice for Triton to make, and
// the fp8/int8 casts are the same device functions (common.cuh) that kernels
// A-D use, so the stored bytes equal the plain version's by construction.
#include "common.cuh"

namespace snap {

constexpr int kAppendWarps = 4;

template <int F>
__global__ void __launch_bounds__(kAppendWarps * 32)
k_append_kernel(const float* __restrict__ c_kv, const float* __restrict__ k_r,
                typename Format<F>::T* __restrict__ content, __nv_bfloat16* __restrict__ rope,
                float* __restrict__ scale, const int* __restrict__ seq_lens, int B, int N,
                int d_c, int d_r) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kAppendWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* c = c_kv + static_cast<size_t>(b) * d_c;
  float amax = 0.f;
  for (int d = lane; d < d_c; d += 32) amax = fmaxf(amax, fabsf(c[d]));
  const float sig = dynamic_scale<F>(warp_max(amax));
  const int row = min(max(seq_lens[b], 0), N - 1);
  const size_t r0 = static_cast<size_t>(b) * N + row;
  typename Format<F>::T* out_c = content + r0 * d_c;
  for (int d = lane; d < d_c; d += 32) out_c[d] = Format<F>::cast(c[d] / sig);
  const float* r = k_r + static_cast<size_t>(b) * d_r;
  __nv_bfloat16* out_r = rope + r0 * d_r;
  for (int k = lane; k < d_r; k += 32) out_r[k] = __float2bfloat16_rn(r[k] / sig);
  if (lane == 0) scale[r0] = sig;
}

}  // namespace snap

extern "C" int snapmla_fused_k_append(int fmt, const void* c_kv, const void* k_r,
                                      void* content, void* rope, void* scale,
                                      const void* seq_lens, int B, int N, int d_c, int d_r,
                                      void* stream) {
  using namespace snap;
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kAppendWarps - 1) / kAppendWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(c_kv);
  const auto* r = static_cast<const float*>(k_r);
  auto* ro = static_cast<__nv_bfloat16*>(rope);
  auto* sc = static_cast<float*>(scale);
  const auto* sl = static_cast<const int*>(seq_lens);
  switch (fmt) {
    case kFp8:
      k_append_kernel<kFp8><<<grid, kAppendWarps * 32, 0, st>>>(
          c, r, static_cast<uint8_t*>(content), ro, sc, sl, B, N, d_c, d_r);
      break;
    case kInt8:
      k_append_kernel<kInt8><<<grid, kAppendWarps * 32, 0, st>>>(
          c, r, static_cast<int8_t*>(content), ro, sc, sl, B, N, d_c, d_r);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
