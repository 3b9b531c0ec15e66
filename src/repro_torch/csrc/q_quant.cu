// Fused-Q-Quant for Hopper (sm_90a) — kernel D of the SnapMLA port.
//
// Replaces repro/kernels/quantize/kernel.py: fused_q_quant_pallas
// (_q_quant_kernel, pallas_call at :59): per (token, head) row, sigma_q =
// max(max|q_c|, EPS) * f32(1/qmax), q_c8 = cast(q_c / sigma_q) and the RoPE
// half divided by sigma_q in float32 (Eq. 6 domain alignment), in one launch.
//
// What bounds it on the H100. A row is 2.3 KB at the MLA widths (d_c 512 and
// d_r 64 floats in; 512 codes, 64 floats and sigma out) with no tensor-core
// work. At the layer API's decode shapes (batch 4 x 32 or 128 heads: 128 or
// 512 rows, 0.3 or 1.2 MB) the bytes take 0.1-0.4 us, so the launch's latency
// bounds it. At deepseek-v3-mla's 128 heads and batch 64 (8,192 rows, 25.2
// MB) the bytes do: 7.5 us at 3.35 TB/s.
//
// The design. One warp per row, kQuantRows (4) warps per block: of 1, 2, 4
// and 8, timed at the layer API's shapes and at batch 64 x 128 heads, none
// was fastest at every shape and 4 stayed within 4% of the fastest at each
// (scripts/diagnose_token_prep.py widths). At the MLA widths (the
// compile-time kTokenDc, kTokenDr of common.cuh: every loop unrolled) a lane
// reads its 16 contiguous content floats as four 16-byte loads and lanes 0-15
// one float4 of rope each, all in flight at once (TokenRow); max|.| over the
// registers, warp_max, then the division and the cast from the registers (the
// row is read once); a lane's 16 codes go out as one 16-byte store, the rope
// quotients as one float4 store, sigma from lane 0. Any other width, or a
// pointer that is not 16-byte aligned, takes the runtime-width instantiation
// of the same kernel (scalar loads and stores, no alignment assumed). True
// IEEE division and the casts of common.cuh keep the bytes equal to the plain
// version's (kernels/quantize/ref.py).
//
// The model's decode and verify steps do not launch D: every MLA decode kernel
// quantizes the raw query in its prologue with these bits (mla_decode.cu).
// This launch serves the layer API (core/snapmla.decode_step), which mirrors
// the reference's separate Fused-Q-Quant call.
#include "common.cuh"

namespace snap {

// rows (warps) per block; -DSNAPMLA_Q_ROWS=w builds another width, which
// scripts/diagnose_token_prep.py times
#ifndef SNAPMLA_Q_ROWS
#define SNAPMLA_Q_ROWS 4
#endif
constexpr int kQuantRows = SNAPMLA_Q_ROWS;

// DC = DR = 0: the runtime-width instantiation (d_c, d_r)
template <int F, int DC, int DR>
__global__ void __launch_bounds__(kQuantRows * 32)
fused_q_quant_kernel(const float* __restrict__ q, typename Format<F>::T* __restrict__ q_c8,
                     float* __restrict__ q_r, float* __restrict__ sigma_q, int rows, int d_c,
                     int d_r) {
  const int lane = threadIdx.x & 31;
  const int row_i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row_i >= rows) return;
  const size_t row = static_cast<size_t>(row_i);
  if constexpr (DC > 0) {
    using Row = TokenRow<DC, DR>;
    const float* src = q + row * (DC + DR);
    Row t;
    t.load(src, src + DC, lane);
    const float sq = t.template scale<F>();
    t.template store_content<F>(q_c8 + row * DC, sq, lane);
    if (lane < Row::kRopeLanes) reinterpret_cast<float4*>(q_r + row * DR)[lane] = t.rope_over(sq);
    if (lane == 0) sigma_q[row] = sq;
  } else {
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
}

template <int F>
int launch_q_quant(bool full, const float* q, void* q_c8, float* q_r, float* sigma_q, int rows,
                   int d_c, int d_r, cudaStream_t st) {
  using T = typename Format<F>::T;
  const dim3 grid((rows + kQuantRows - 1) / kQuantRows);
  const dim3 block(kQuantRows * 32);
  if (full)
    fused_q_quant_kernel<F, kTokenDc, kTokenDr><<<grid, block, 0, st>>>(
        q, static_cast<T*>(q_c8), q_r, sigma_q, rows, d_c, d_r);
  else
    fused_q_quant_kernel<F, 0, 0><<<grid, block, 0, st>>>(q, static_cast<T*>(q_c8), q_r,
                                                          sigma_q, rows, d_c, d_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace snap

// full: the compile-time-width instantiation (d_c, d_r must be kTokenDc,
// kTokenDr and every pointer 16-byte aligned)
extern "C" int snapmla_fused_q_quant(int fmt, const void* q, void* q_c8, void* q_r,
                                     void* sigma_q, int B, int H, int d_c, int d_r, int full,
                                     void* stream) {
  using namespace snap;
  const long long rows = static_cast<long long>(B) * H;
  if (rows < 1 || rows > 0x7fffffff || d_c < 1 || d_r < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (full && (d_c != kTokenDc || d_r != kTokenDr || !aligned16({q, q_c8, q_r, sigma_q})))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(q);
  auto* qr = static_cast<float*>(q_r);
  auto* sq = static_cast<float*>(sigma_q);
  switch (fmt) {
    case kFp8:
      return launch_q_quant<kFp8>(full, src, q_c8, qr, sq, static_cast<int>(rows), d_c, d_r, st);
    case kInt8:
      return launch_q_quant<kInt8>(full, src, q_c8, qr, sq, static_cast<int>(rows), d_c, d_r, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
