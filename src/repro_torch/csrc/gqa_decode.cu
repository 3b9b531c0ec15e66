// FP8 per-token quantized GQA decode for Hopper (sm_90a) — #7 of the port.
//
// Replaces repro/kernels/gqa_decode/kernel.py: gqa_decode_pallas
// (_gqa_decode_kernel). Per batch row b, kv head h and query head j < g
// (query row h*g + j) it walks the cache in blocks of bn slots, in order,
// with no early exit:
//   s     = (q . k) * ks * f32(1/sqrt(dh)), -1e30 where the slot is invalid
//           (slot_pos < 0, slot_pos > positions[b], or, with a window,
//           slot_pos <= positions[b] - window; slots n >= N, the reference's
//           padding, are invalid too);
//   m     = max(m_prev, max s), e = exp(s - m), 0 on invalid slots;
//   p~    = e * vs (Key Step 2: V's per-token scale fused into P),
//   sigma_p = max(max|p~|, EPS) / qmax over exactly this block of this row,
//   P8    = cast(p~ / sigma_p) (fp8: clip +-448, round to nearest even;
//           int8: round half to even, clip +-127; none: P8 = p~, sigma_p = 1);
//   corr  = exp(m_prev - m) * sigma_p_prev / sigma_p;
//   l     = l * corr + sum(e) / sigma_p, acc = acc * corr + P8 . V;
// and writes o = acc / l (a row with no valid slot: 0 / 0 = NaN).
//
// Design. One block of 256 threads per (kv head, batch row), walking the
// blocks with the g query rows' m, l, sigma_p, corr and acc[g, dh] in shared
// memory (the sequential grid axis of the TPU kernel becomes this loop:
// sigma_p's chain needs monotone order). Per block:
//   0. validity, ks and vs of the bn slots; a block with no valid slot skips
//      its K and V loads and both dots (its P is all zero), but still runs the
//      sigma_p update, as the reference does;
//   1. QK: a group of dh*sizeof(T)/16 lanes per slot, one 16-byte chunk of the
//      slot's K row each, widened once and dotted with all g query rows in
//      float64; the group adds its partial sums by shuffles;
//   2. one warp per query row: the online max, e, p~, sigma_p, P8, corr, l;
//   3. V's block staged in shared memory (read once for all g rows), then one
//      thread per (row, d): the PV dot over the block in float64,
//      acc = acc * corr + f32(pv).
// The QK and PV dots and the sum of e accumulate in float64 and round once,
// as the plain version (kernels/gqa_decode/ref.py) does, so the two agree bit
// for bit wherever the float64 summation order does not show (fp8 x fp8 PV
// sums are exact in any order). Every float32 product and sum whose rounding
// the plain version fixes is written with __fmul_rn / __fadd_rn / __fsub_rn
// so nvcc cannot contract it into an FMA.
//
// Bound on the H100: bytes — the valid slots' K, V and scales, slot_pos for
// all N slots, q and o, at 3.35 TB/s (a few MB per decode call at serving
// shapes, ~277 MB at 32k tokens per row). This simple version is far from it:
// only B * Hkv blocks run (32 on 132 SMs at llama3.2-3b's serving batch), the
// dots run in float64 on the CUDA cores, and the loads are not overlapped
// with compute. Left for later: splitting the walk (which changes the result
// through an LSE combine), fp8 wgmma for both dots, TMA block loads in a ring
// of shared-memory stages.
#include "common.cuh"

namespace snap {

constexpr int kGqaThreads = 256;
constexpr int kGqaWarps = kGqaThreads / 32;

// byte offsets into the dynamic shared memory of one block
struct GqaLayout {
  int q, s, v, acc, ks, vs, valid, state, total;
};

static int gqa_take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

template <int F>
static GqaLayout gqa_layout(int g, int dh, int bn) {
  GqaLayout L;
  int off = 0;
  L.q = gqa_take(off, g * dh * 8);
  L.s = gqa_take(off, g * bn * 4);
  L.v = gqa_take(off, bn * dh * static_cast<int>(sizeof(typename Format<F>::T)));
  L.acc = gqa_take(off, g * dh * 4);
  L.ks = gqa_take(off, bn * 4);
  L.vs = gqa_take(off, bn * 4);
  L.valid = gqa_take(off, bn * 4);
  L.state = gqa_take(off, 4 * g * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The values of one 16-byte chunk of a K row, widened to float64 (exactly).
template <int F> struct Chunk;

template <> struct Chunk<kFp8> {
  static constexpr int kVals = 16;
  static __device__ __forceinline__ void widen(const uint4& w, double (&out)[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(words[i] & 0xffffu), __NV_E4M3)));
      const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(words[i] >> 16), __NV_E4M3)));
      out[4 * i] = lo.x;
      out[4 * i + 1] = lo.y;
      out[4 * i + 2] = hi.x;
      out[4 * i + 3] = hi.y;
    }
  }
};

template <> struct Chunk<kInt8> {
  static constexpr int kVals = 16;
  static __device__ __forceinline__ void widen(const uint4& w, double (&out)[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * i + e] = static_cast<int8_t>((words[i] >> (8 * e)) & 0xffu);
  }
};

template <> struct Chunk<kNone> {
  static constexpr int kVals = 8;
  static __device__ __forceinline__ void widen(const uint4& w, double (&out)[8]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

template <int F>
__global__ void __launch_bounds__(kGqaThreads)
gqa_decode_kernel(const float* __restrict__ q, const typename Format<F>::T* __restrict__ k,
                  const typename Format<F>::T* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                  const int* __restrict__ positions, float* __restrict__ o, int N, int Hkv,
                  int g, int dh, int bn, int window, float sm_scale, GqaLayout L) {
  using Fm = Format<F>;
  using T = typename Fm::T;
  using C = Chunk<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* q_s = reinterpret_cast<double*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);  // logits, then P8 (as float)
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int* valid_s = reinterpret_cast<int*>(smem + L.valid);
  float* m_s = reinterpret_cast<float*>(smem + L.state);
  float* l_s = m_s + g;
  float* sp_s = l_s + g;
  float* corr_s = sp_s + g;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = Hkv * g;
  const int pos = positions[b];
  const size_t q0 = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * g) * dh;
  for (int i = tid; i < g * dh; i += kGqaThreads) {
    q_s[i] = static_cast<double>(q[q0 + i]);
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < g; j += kGqaThreads) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
    sp_s[j] = 1.f;
  }

  const int chunks = dh * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a row
  const int per_pass = kGqaThreads / chunks;                 // slots per QK pass
  const size_t row_stride = static_cast<size_t>(Hkv) * dh;   // elements between slots
  const int nb = (N + bn - 1) / bn;
  for (int blk = 0; blk < nb; ++blk) {
    const int n0 = blk * bn;
    // 0. the block's slots: validity and scales
    int any = 0;
    for (int t = tid; t < bn; t += kGqaThreads) {
      const int n = n0 + t;
      int ok = 0;
      float ksv = 1.f, vsv = 1.f;
      if (n < N) {
        const size_t bn_idx = static_cast<size_t>(b) * N + n;
        const int sp = slot_pos[bn_idx];
        ok = sp >= 0 && sp <= pos && (window == 0 || sp > pos - window);
        ksv = k_scale[bn_idx * Hkv + h];
        vsv = v_scale[bn_idx * Hkv + h];
      }
      valid_s[t] = ok;
      ks_s[t] = ksv;
      vs_s[t] = vsv;
      any |= ok;
    }
    const bool live = __syncthreads_or(any) != 0;

    // 1. s = (q . k) * ks * sm_scale on valid slots, -1e30 elsewhere
    if (live) {
      const int c = tid % chunks;
      for (int base = 0; base < bn; base += per_pass) {
        const int t = base + tid / chunks;
        const bool in = t < bn && valid_s[t];
        double kv[C::kVals];
        if (in) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              k + (static_cast<size_t>(b) * N + n0 + t) * row_stride + static_cast<size_t>(h) * dh +
              c * C::kVals);
          C::widen(w, kv);
        } else {
#pragma unroll
          for (int e = 0; e < C::kVals; ++e) kv[e] = 0.0;
        }
        for (int j = 0; j < g; ++j) {
          const double* qj = q_s + j * dh + c * C::kVals;
          double a = 0.0;
#pragma unroll
          for (int e = 0; e < C::kVals; ++e) a = fma(qj[e], kv[e], a);
          for (int off = chunks / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (c == 0 && t < bn)
            s_s[j * bn + t] = in ? __fmul_rn(__fmul_rn(static_cast<float>(a), ks_s[t]), sm_scale)
                                 : kNegInf;
        }
      }
    } else {
      for (int i = tid; i < g * bn; i += kGqaThreads) s_s[i] = kNegInf;
    }
    __syncthreads();

    // 2. online softmax + scale fusion + block-wise dynamic P quantization
    for (int j = warp; j < g; j += kGqaWarps) {
      float* sj = s_s + j * bn;
      const float m_prev = m_s[j], l_prev = l_s[j], sp_prev = sp_s[j];
      float mx = m_prev;
      for (int t = lane; t < bn; t += 32) mx = fmaxf(mx, sj[t]);
      mx = warp_max(mx);
      float amax = 0.f;
      double esum = 0.0;
      for (int t = lane; t < bn; t += 32) {
        const bool ok = valid_s[t] != 0;
        const float e = ok ? expf(__fsub_rn(sj[t], mx)) : 0.f;
        const float pf = ok ? __fmul_rn(e, vs_s[t]) : 0.f;
        esum += static_cast<double>(e);
        amax = fmaxf(amax, fabsf(pf));
        sj[t] = pf;
      }
      amax = warp_max(amax);
      esum = warp_sum_f64(esum);
      float sp_new = 1.f;  // "none": scale-fused but unquantized P
      if constexpr (F != kNone) {
        sp_new = dynamic_scale<F>(amax);
        for (int t = lane; t < bn; t += 32) sj[t] = Fm::widen(Fm::cast(sj[t] / sp_new));
      }
      if (lane == 0) {
        const float corr = __fmul_rn(expf(__fsub_rn(m_prev, mx)), sp_prev / sp_new);
        l_s[j] = __fadd_rn(__fmul_rn(l_prev, corr), static_cast<float>(esum) / sp_new);
        m_s[j] = mx;
        sp_s[j] = sp_new;
        corr_s[j] = corr;
      }
    }
    // stage the block's V rows (zeros past N, the reference's padding)
    if (live) {
      const int words = dh * static_cast<int>(sizeof(T)) / 16;
      uint4* dst = reinterpret_cast<uint4*>(v_s);
      for (int i = tid; i < bn * words; i += kGqaThreads) {
        const int t = i / words, w = i - t * words;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + t < N)
          val = reinterpret_cast<const uint4*>(
              v + (static_cast<size_t>(b) * N + n0 + t) * row_stride + static_cast<size_t>(h) * dh)[w];
        dst[i] = val;
      }
    }
    __syncthreads();

    // 3. implicit dequantization: acc = acc * corr + P8 . V
    for (int i = tid; i < g * dh; i += kGqaThreads) {
      const int j = i / dh, d = i - j * dh;
      double pv = 0.0;
      if (live) {
        const float* pj = s_s + j * bn;
        for (int t = 0; t < bn; ++t)
          pv = fma(static_cast<double>(pj[t]), static_cast<double>(Fm::widen(v_s[t * dh + d])), pv);
      }
      acc_s[i] = __fadd_rn(__fmul_rn(acc_s[i], corr_s[j]), static_cast<float>(pv));
    }
    __syncthreads();  // the next block overwrites the staged tiles and the state
  }

  for (int i = tid; i < g * dh; i += kGqaThreads) o[q0 + i] = acc_s[i] / l_s[i / dh];
}

template <int F>
static cudaError_t launch_gqa(const float* q, const void* k, const void* v, const float* ks,
                              const float* vs, const int* slot_pos, const int* positions, float* o,
                              int B, int N, int Hkv, int g, int dh, int bn, int window,
                              float sm_scale, cudaStream_t stream) {
  using T = typename Format<F>::T;
  const GqaLayout L = gqa_layout<F>(g, dh, bn);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = gqa_decode_kernel<F>;
  // raise the dynamic shared-memory limit once (grow-only), so a later call
  // inside CUDA-graph capture makes no attribute call
  static int smem_limit = 0;
  if (L.total > smem_limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    smem_limit = L.total;
  }
  const dim3 grid(Hkv, B);
  kern<<<grid, kGqaThreads, L.total, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, slot_pos, positions, o, N,
      Hkv, g, dh, bn, window, sm_scale, L);
  return cudaGetLastError();
}

}  // namespace snap

// q [B, H, dh] f32, k / v [B, N, Hkv, dh] (fp8 / int8 / bf16 by fmt, 16-byte
// aligned), k_scale / v_scale [B, N, Hkv] f32, slot_pos [B, N] int32,
// positions [B] int32 -> o [B, H, dh] f32, H = Hkv * g. dh in {16, 32, 64,
// 128}; block a power of two in [16, 512]; N need not be a multiple of it.
extern "C" int snapmla_gqa_decode(int fmt, const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* slot_pos,
                                  const void* positions, void* o, int B, int N, int Hkv, int g,
                                  int dh, int block, int window, float sm_scale, void* stream) {
  using namespace snap;
  const bool dh_ok = dh == 16 || dh == 32 || dh == 64 || dh == 128;
  const bool block_ok = block >= 16 && block <= 512 && (block & (block - 1)) == 0;
  if (!dh_ok || !block_ok || B < 1 || N < 1 || Hkv < 1 || g < 1 || window < 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* sp = static_cast<const int*>(slot_pos);
  const auto* ps = static_cast<const int*>(positions);
  auto* out = static_cast<float*>(o);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fmt) {
    case kFp8:
      err = launch_gqa<kFp8>(qf, k, v, ks, vs, sp, ps, out, B, N, Hkv, g, dh, block, window,
                             sm_scale, st);
      break;
    case kInt8:
      err = launch_gqa<kInt8>(qf, k, v, ks, vs, sp, ps, out, B, N, Hkv, g, dh, block, window,
                              sm_scale, st);
      break;
    case kNone:
      err = launch_gqa<kNone>(qf, k, v, ks, vs, sp, ps, out, B, N, Hkv, g, dh, block, window,
                              sm_scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
