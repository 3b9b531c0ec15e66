// Fused-K-Append for Hopper (sm_90a) — kernel #9 of the SnapMLA port.
//
// Replaces repro/kernels/quantize/kernel.py: fused_k_append_pallas
// (_k_append_kernel, pallas_call at :148): for each batch row b, the new
// latent entry is quantized per token and written in place at row
// seq_lens[b] of the contiguous cache — sigma_k = max(max|c_kv|, EPS) *
// f32(1/qmax) (the product with the reciprocal, as the reference's compiled
// form computes it), content = cast(c_kv / sigma_k), rope = bf16(k_r /
// sigma_k) (Eq. 6 domain alignment) and scale = sigma_k. It touches only that
// row; the TPU kernel rewrites the whole page only because a Pallas block is
// a page. The row index is clamped to the last row, as the reference's
// dynamic_update_slice clamps it.
//
// What bounds it on the H100: launch latency at every batch a decode step
// has. It reads (d_c + d_r) * 4 + 4 and writes d_c + 2 * d_r + 4 bytes per
// row (3.0 KB at the MLA widths: 0.06 us of bytes at batch 64).
//
// The design: nothing is worth tiling, so the row's loads go out at once and
// the rows spread over the SMs. One block of one warp per batch row (batch 4
// runs on 4 SMs). seq_lens[b] is loaded first, beside the row's loads, so the
// write position is known when the codes are. At the MLA widths (the
// compile-time kTokenDc, kTokenDr of common.cuh) a lane reads its 16
// contiguous content floats as four 16-byte loads and lanes 0-15 one float4
// of rope each (TokenRow); max|.|, warp_max, then division and cast from the
// registers (the row is read once); a lane's 16 codes go out as one 16-byte
// store, its 4 bf16 rope values as one 8-byte store, sigma from lane 0. Any
// other width, or a pointer that is not 16-byte aligned, takes the
// runtime-width instantiation of the same kernel (scalar loads and stores, no
// alignment assumed). CUDA rather than Triton: the fp8/int8 casts are the
// device functions (common.cuh) that every kernel of the port uses, so the
// stored bytes equal the plain version's by construction.
#include "common.cuh"

namespace snap {

// DC = DR = 0: the runtime-width instantiation (d_c, d_r)
template <int F, int DC, int DR>
__global__ void __launch_bounds__(32)
k_append_kernel(const float* __restrict__ c_kv, const float* __restrict__ k_r,
                typename Format<F>::T* __restrict__ content, __nv_bfloat16* __restrict__ rope,
                float* __restrict__ scale, const int* __restrict__ seq_lens, int N, int d_c,
                int d_r) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int pos = seq_lens[b];
  const size_t row = static_cast<size_t>(b) * N + min(max(pos, 0), N - 1);
  if constexpr (DC > 0) {
    using Row = TokenRow<DC, DR>;
    Row t;
    t.load(c_kv + static_cast<size_t>(b) * DC, k_r + static_cast<size_t>(b) * DR, lane);
    const float sig = t.template scale<F>();
    t.template store_content<F>(content + row * DC, sig, lane);
    if (lane < Row::kRopeLanes)
      reinterpret_cast<uint2*>(rope + row * DR)[lane] = pack_bf16x4(t.rope_over(sig));
    if (lane == 0) scale[row] = sig;
  } else {
    const float* c = c_kv + static_cast<size_t>(b) * d_c;
    float amax = 0.f;
    for (int d = lane; d < d_c; d += 32) amax = fmaxf(amax, fabsf(c[d]));
    const float sig = dynamic_scale<F>(warp_max(amax));
    typename Format<F>::T* out_c = content + row * d_c;
    for (int d = lane; d < d_c; d += 32) out_c[d] = Format<F>::cast(c[d] / sig);
    const float* r = k_r + static_cast<size_t>(b) * d_r;
    __nv_bfloat16* out_r = rope + row * d_r;
    for (int k = lane; k < d_r; k += 32) out_r[k] = __float2bfloat16_rn(r[k] / sig);
    if (lane == 0) scale[row] = sig;
  }
}

template <int F>
int launch_k_append(bool full, const float* c, const float* r, void* content,
                    __nv_bfloat16* rope, float* scale, const int* seq_lens, int B, int N,
                    int d_c, int d_r, cudaStream_t st) {
  using T = typename Format<F>::T;
  if (full)
    k_append_kernel<F, kTokenDc, kTokenDr><<<B, 32, 0, st>>>(
        c, r, static_cast<T*>(content), rope, scale, seq_lens, N, d_c, d_r);
  else
    k_append_kernel<F, 0, 0><<<B, 32, 0, st>>>(c, r, static_cast<T*>(content), rope, scale,
                                               seq_lens, N, d_c, d_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace snap

// full: the compile-time-width instantiation (d_c, d_r must be kTokenDc,
// kTokenDr and every pointer 16-byte aligned)
extern "C" int snapmla_fused_k_append(int fmt, const void* c_kv, const void* k_r,
                                      void* content, void* rope, void* scale,
                                      const void* seq_lens, int B, int N, int d_c, int d_r,
                                      int full, void* stream) {
  using namespace snap;
  if (B < 1 || N < 1 || d_c < 1 || d_r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (full && (d_c != kTokenDc || d_r != kTokenDr ||
               !aligned16({c_kv, k_r, content, rope, scale, seq_lens})))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(c_kv);
  const auto* r = static_cast<const float*>(k_r);
  auto* ro = static_cast<__nv_bfloat16*>(rope);
  auto* sc = static_cast<float*>(scale);
  const auto* sl = static_cast<const int*>(seq_lens);
  switch (fmt) {
    case kFp8:
      return launch_k_append<kFp8>(full, c, r, content, ro, sc, sl, B, N, d_c, d_r, st);
    case kInt8:
      return launch_k_append<kInt8>(full, c, r, content, ro, sc, sl, B, N, d_c, d_r, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
