// Fused-Q-Quant for Hopper (sm_90a) — kernel D of the SnapMLA port.
//
// Replaces repro/kernels/quantize/kernel.py: fused_q_quant_pallas
// (_q_quant_kernel): per (token, head) sigma_q = max(max|q_c|, EPS)/qmax,
// q_c8 = cast(q_c / sigma_q) and the RoPE half divided by sigma_q in float32
// (Eq. 6 domain alignment), all in one launch. One warp per head, kWarps heads
// of one token per block.
//
// Bound on the H100: bytes — it reads (d_c + d_r) * 4 bytes and writes
// d_c + d_r * 4 + 4 bytes per (token, head), a few hundred kilobytes per decode
// step, so its time is launch latency. The model's decode and verify steps
// therefore do not launch it: every MLA decode kernel takes the raw query and
// runs these operations in its prologue (mla_decode.cu, step 0), with the
// same bits. This launch serves the layer API (core/snapmla.decode_step),
// which mirrors the reference's separate Fused-Q-Quant call.
#include "common.cuh"

namespace snap {

constexpr int kQuantWarps = 8;

template <int F>
__global__ void __launch_bounds__(kQuantWarps * 32)
fused_q_quant_kernel(const float* __restrict__ q, typename Format<F>::T* __restrict__ q_c8,
                     float* __restrict__ q_r, float* __restrict__ sigma_q, int H, int d_c,
                     int d_r) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (h >= H) return;
  const size_t row = static_cast<size_t>(b) * H + h;
  const float* src = q + row * (d_c + d_r);
  float amax = 0.f;
  for (int d = lane; d < d_c; d += 32) amax = fmaxf(amax, fabsf(src[d]));
  const float sq = dynamic_scale<F>(warp_max(amax));
  typename Format<F>::T* out_c = q_c8 + row * d_c;
  for (int d = lane; d < d_c; d += 32) out_c[d] = Format<F>::cast(src[d] / sq);
  float* out_r = q_r + row * d_r;
  for (int k = lane; k < d_r; k += 32) out_r[k] = src[d_c + k] / sq;
  if (lane == 0) sigma_q[row] = sq;
}

}  // namespace snap

extern "C" int snapmla_fused_q_quant(int fmt, const void* q, void* q_c8, void* q_r,
                                     void* sigma_q, int B, int H, int d_c, int d_r,
                                     void* stream) {
  using namespace snap;
  const dim3 grid((H + kQuantWarps - 1) / kQuantWarps, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(q);
  auto* qr = static_cast<float*>(q_r);
  auto* sq = static_cast<float*>(sigma_q);
  switch (fmt) {
    case kFp8:
      fused_q_quant_kernel<kFp8><<<grid, kQuantWarps * 32, 0, st>>>(
          src, static_cast<uint8_t*>(q_c8), qr, sq, H, d_c, d_r);
      break;
    case kInt8:
      fused_q_quant_kernel<kInt8><<<grid, kQuantWarps * 32, 0, st>>>(
          src, static_cast<int8_t*>(q_c8), qr, sq, H, d_c, d_r);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
