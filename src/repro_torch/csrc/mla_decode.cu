// SnapMLA paged FP8 decode for Hopper (sm_90a): the scale-fused split-KV
// kernel, its single-pass mode, and the LSE combine.
//
// Replaces (the reference JAX package, Pallas on TPU):
//   A  paged split-KV decode   repro/kernels/mla_decode/kernel.py:
//        mla_decode_paged_splitkv_pallas (_paged_splitkv_body ->
//        _mla_decode_splitkv_kernel -> _block_pipeline, FMA rescale, q_len = 1)
//   B  paged single pass       kernel.py: mla_decode_paged_pallas
//        (_paged_body -> _mla_decode_kernel): the same kernel compiled with
//        kSinglePass = true
//   C  LSE combine             kernel.py: lse_combine_pallas (_lse_combine_kernel)
//
// Design. One block of 512 threads per (head tile of kHeads heads, split,
// batch row); the block walks its split's logical pages in order (the sigma_p
// scale chain needs monotone order, kernel.py:27-38), resolving each through
// the page table. Per page it stages content, rope and scale in shared
// memory, then
//   1. s = (q_c8.C + q_r.R) * (sigma_q x sigma_k) * scale, masked to
//      tok < seq_len with the -1e30 sentinel. A group of lanes per token
//      widens the token's content once for all heads of the tile. Both dots
//      accumulate in float64 and round once to float32: a product of two fp8
//      values is exact, so the content dot is exact in any order and the
//      kernel agrees bit for bit with the plain PyTorch version (ref.py) —
//      which matters because P's fp8 rounding below flips on a one-ulp
//      change of a logit;
//   2. online softmax (one warp per head): m_new, e = exp(s - m_new),
//      p~ = e * sigma_k, sigma_p = max(max|p~|, EPS)/qmax over exactly one page,
//      P8 = fp8(p~ / sigma_p) read back as f32, corr = exp(m_prev - m_new) *
//      sigma_p_prev / sigma_p, l = l*corr + sum(e)/sigma_p;
//   3. acc = acc*corr + P8.C with the accumulator in registers.
// Split mode (A) skips dead pages (g*page >= seq_len: neither loaded nor
// computed) and publishes (0, -1e30, sigma_p = 1) for an empty split.
// Single-pass mode (B) has no early exit: a dead page runs the sigma_p update
// with an all-masked block (sigma_p floors at EPS/qmax); its loads are elided
// because masked entries contribute exact zeros.
//
// Bound on the H100: 644 bytes per live token (512 fp8 content + 128 bf16
// rope + 4 scale) at 3.35 TB/s, i.e. memory-bound at the card's rates. This
// simple version is far from that bound: the float64 QK dot and the conversions
// run on the CUDA cores, each head tile re-reads its page (from L2), and the
// loads are not overlapped with compute. Left for later: fp8 wgmma for QK and
// PV with an exactness-preserving accumulation, TMA page loads in a ring of
// shared-memory stages, all heads of a row in one warp-specialised block, and
// the combine folded into A's epilogue.
#include "common.cuh"

namespace snap {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8;           // heads per block: one warp per head in step 2
constexpr int kMaxDcPerThread = 2;  // d_c <= kThreads * kMaxDcPerThread

// byte offsets into the dynamic shared memory of one block
struct Layout {
  int q, qr, c, r, sk, p, state, total;
  int c_row_words, r_row_words;
};

static int take(int& off, int bytes) {
  int at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// Row stride (in 32-bit words) of a staged tile read by groups of `tpt`
// lanes per token at word offsets j, j + tpt, ...: congruent to tpt mod 32,
// so the lanes of a warp hit distinct banks.
static int padded_row_words(int words, int tpt) {
  return words + (((tpt - words) % 32) + 32) % 32;
}

template <int F>
static Layout layout(int d_c, int d_r, int page) {
  Layout L;
  const int esize = sizeof(typename Format<F>::T);
  const int tpt = kThreads / page;
  L.c_row_words = padded_row_words(d_c * esize / 4, tpt);
  L.r_row_words = padded_row_words(d_r / 2, tpt);
  int off = 0;
  L.q = take(off, kHeads * d_c * 8);
  L.qr = take(off, kHeads * d_r * 8);
  L.c = take(off, page * L.c_row_words * 4);
  L.r = take(off, page * L.r_row_words * 4);
  L.sk = take(off, page * 4);
  L.p = take(off, kHeads * page * 4);
  L.state = take(off, 4 * kHeads * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The values packed in one 32-bit word of a content row, widened to float64
// (exactly: every storage format is a subset of float64).
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

template <int F, bool kSinglePass>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const typename Format<F>::T* __restrict__ q_c8,
                    const float* __restrict__ q_r, const float* __restrict__ sigma_q,
                    const typename Format<F>::T* __restrict__ content,
                    const __nv_bfloat16* __restrict__ rope,
                    const float* __restrict__ scale,
                    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
                    float* __restrict__ o_part, float* __restrict__ lse_part,
                    float* __restrict__ sp_part, int H, int d_c, int d_r, int page,
                    int P, int pages_per_split, float softmax_scale, Layout L) {
  using Fm = Format<F>;
  using T = typename Fm::T;
  extern __shared__ __align__(16) unsigned char smem[];
  double* q_s = reinterpret_cast<double*>(smem + L.q);
  double* qr_s = reinterpret_cast<double*>(smem + L.qr);
  uint32_t* c_s = reinterpret_cast<uint32_t*>(smem + L.c);
  uint32_t* r_s = reinterpret_cast<uint32_t*>(smem + L.r);
  float* sk_s = reinterpret_cast<float*>(smem + L.sk);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.state);
  float* l_s = m_s + kHeads;
  float* sp_s = l_s + kHeads;
  float* corr_s = sp_s + kHeads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * kHeads;
  const int nh = min(kHeads, H - h0);
  const int split = blockIdx.y, S = gridDim.y;
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const size_t row0 = static_cast<size_t>(b) * H + h0;

  for (int i = tid; i < nh * d_c; i += kThreads) q_s[i] = Fm::widen(q_c8[row0 * d_c + i]);
  const int tpt = kThreads / page;  // lanes per token in step 1 (power of two, <= 32)
  for (int i = tid; i < nh * d_r; i += kThreads) qr_s[i] = static_cast<double>(q_r[row0 * d_r + i]);
  if (tid < kHeads) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    sp_s[tid] = 1.f;
  }
  float acc[kHeads][kMaxDcPerThread];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int i = 0; i < kMaxDcPerThread; ++i) acc[h][i] = 0.f;
  __syncthreads();

  const int c_words = d_c * static_cast<int>(sizeof(T)) / 4;  // words per content row
  const int r_words = d_r / 2;
  const int c_row_bytes = L.c_row_words * 4;
  const int first = split * pages_per_split;
  const int last = min(first + pages_per_split, P);
  for (int g = first; g < last; ++g) {
    const bool live = g * page < seq_len;
    if (!kSinglePass && !live) break;  // early exit: valid tokens are a prefix
    if (live) {
      const size_t pid = static_cast<size_t>(page_table[static_cast<size_t>(b) * P + g]);
      const uint32_t* src_c = reinterpret_cast<const uint32_t*>(content + pid * page * d_c);
      for (int i = tid; i < page * c_words; i += kThreads) {
        const int t = i / c_words;
        c_s[t * L.c_row_words + (i - t * c_words)] = src_c[i];
      }
      const uint32_t* src_r = reinterpret_cast<const uint32_t*>(rope + pid * page * d_r);
      for (int i = tid; i < page * r_words; i += kThreads) {
        const int t = i / r_words;
        r_s[t * L.r_row_words + (i - t * r_words)] = src_r[i];
      }
      for (int t = tid; t < page; t += kThreads) sk_s[t] = scale[pid * page + t];
      __syncthreads();
      // 1. uniform QK over [content | rope], one sigma_q x sigma_k rescale.
      // A group of tpt lanes per token: each lane widens a strided share of
      // the token's content once and accumulates it for every head of the
      // tile in float64 (fp8 x fp8 products and their sums are exact there,
      // so the split and the order change nothing); the group then adds its
      // partial sums by shuffles.
      {
        using U = Unpack<F>;
        const int t = tid / tpt, j = tid - t * tpt;
        const bool valid = g * page + t < seq_len;
        double ac[kHeads], ar[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) ac[h] = ar[h] = 0.0;
        if (valid) {
          const uint32_t* crow = c_s + t * L.c_row_words;
          for (int w = j; w < c_words; w += tpt) {
            double cv[U::kPerWord];
            U::run(crow[w], cv);
#pragma unroll
            for (int e = 0; e < U::kPerWord; ++e) {
              const double* qk = q_s + w * U::kPerWord + e;
#pragma unroll
              for (int h = 0; h < kHeads; ++h)
                if (h < nh) ac[h] = fma(qk[h * d_c], cv[e], ac[h]);
            }
          }
          const uint32_t* rrow = r_s + t * L.r_row_words;
          for (int w = j; w < r_words; w += tpt) {
            const uint32_t v = rrow[w];
            const double r0 = bf16_lo(v), r1 = bf16_hi(v);
#pragma unroll
            for (int h = 0; h < kHeads; ++h) {
              if (h < nh) {
                ar[h] = fma(qr_s[h * d_r + 2 * w], r0, ar[h]);
                ar[h] = fma(qr_s[h * d_r + 2 * w + 1], r1, ar[h]);
              }
            }
          }
        }
        for (int o = tpt / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < kHeads; ++h) {
            ac[h] += __shfl_xor_sync(0xffffffffu, ac[h], o);
            ar[h] += __shfl_xor_sync(0xffffffffu, ar[h], o);
          }
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          if (h < nh && (h & (tpt - 1)) == j) {
            float s = kNegInf;
            if (valid) {
              s = static_cast<float>(ac[h]) + static_cast<float>(ar[h]);
              s = s * (sigma_q[row0 + h] * sk_s[t]) * softmax_scale;
            }
            p_s[h * page + t] = s;
          }
        }
      }
    } else {
      for (int i = tid; i < nh * page; i += kThreads) p_s[i] = kNegInf;
    }
    __syncthreads();

    // 2. online softmax + scale fusion + block-wise dynamic P quantization
    for (int h = warp; h < nh; h += kWarps) {
      float* ph = p_s + h * page;
      const float m_prev = m_s[h], l_prev = l_s[h], sp_prev = sp_s[h];
      float mx = m_prev;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ph[t]);
      const float m_new = warp_max(mx);
      float amax = 0.f, esum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const bool valid = g * page + t < seq_len;
        const float e = valid ? expf(ph[t] - m_new) : 0.f;
        const float pf = valid ? e * sk_s[t] : 0.f;  // Key Step 2: fuse sigma_k into P
        esum += e;
        amax = fmaxf(amax, fabsf(pf));
        ph[t] = pf;
      }
      amax = warp_max(amax);
      esum = warp_sum(esum);
      float sp_new = 1.f;  // "none": scale-fused but unquantized P
      if constexpr (F != kNone) {
        sp_new = dynamic_scale<F>(amax);
        for (int t = lane; t < page; t += 32) ph[t] = Fm::widen(Fm::cast(ph[t] / sp_new));
      }
      if (lane == 0) {
        const float corr = __fmul_rn(expf(m_prev - m_new), sp_prev / sp_new);  // Eq. 12/13
        l_s[h] = __fadd_rn(__fmul_rn(l_prev, corr), esum / sp_new);
        m_s[h] = m_new;
        sp_s[h] = sp_new;
        corr_s[h] = corr;
      }
    }
    __syncthreads();

    // 3. implicit dequantization: acc = acc * corr + P8 . C
#pragma unroll
    for (int i = 0; i < kMaxDcPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < d_c) {
        float pv[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) pv[h] = 0.f;
        if (live) {
          const unsigned char* col = reinterpret_cast<const unsigned char*>(c_s) + d * sizeof(T);
          for (int t = 0; t < page; t += 4) {  // page % 4 == 0: float4 reads of P
            const unsigned char* ct = col + t * c_row_bytes;
            const float c0 = Fm::widen(*reinterpret_cast<const T*>(ct));
            const float c1 = Fm::widen(*reinterpret_cast<const T*>(ct + c_row_bytes));
            const float c2 = Fm::widen(*reinterpret_cast<const T*>(ct + 2 * c_row_bytes));
            const float c3 = Fm::widen(*reinterpret_cast<const T*>(ct + 3 * c_row_bytes));
#pragma unroll
            for (int h = 0; h < kHeads; ++h) {
              if (h < nh) {
                const float4 p4 = *reinterpret_cast<const float4*>(p_s + h * page + t);
                pv[h] = fmaf(p4.x, c0, pv[h]);
                pv[h] = fmaf(p4.y, c1, pv[h]);
                pv[h] = fmaf(p4.z, c2, pv[h]);
                pv[h] = fmaf(p4.w, c3, pv[h]);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
          if (h < nh) acc[h][i] = __fadd_rn(__fmul_rn(acc[h][i], corr_s[h]), pv[h]);
      }
    }
    __syncthreads();  // the next page overwrites the staged tiles
  }

  // epilogue: (acc / l, m + log(sigma_p * l), sigma_p) — sigma_p cancels in o
  const size_t out0 = (static_cast<size_t>(b) * S + split) * H + h0;
#pragma unroll
  for (int i = 0; i < kMaxDcPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < d_c) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h < nh) {
          const float l = l_s[h];
          float o = acc[h][i] / l;
          if (!kSinglePass && !(l > 0.f)) o = 0.f;  // empty split: neutral partial
          o_part[(out0 + h) * d_c + d] = o;
        }
      }
    }
  }
  if (tid < nh) {
    const float l = l_s[tid];
    float lse = m_s[tid] + logf(sp_s[tid] * l);
    if (!kSinglePass && !(l > 0.f)) lse = kNegInf;
    lse_part[out0 + tid] = lse;
    if (sp_part != nullptr) sp_part[out0 + tid] = sp_s[tid];
  }
}

template <int F, bool kSinglePass>
static cudaError_t launch_decode(const void* q_c8, const float* q_r, const float* sigma_q,
                                 const void* content, const void* rope, const float* scale,
                                 const int* page_table, const int* seq_lens, float* o_part,
                                 float* lse_part, float* sp_part, int B, int H, int d_c,
                                 int d_r, int page, int P, int num_splits,
                                 int pages_per_split, float softmax_scale,
                                 cudaStream_t stream) {
  using T = typename Format<F>::T;
  const Layout L = layout<F>(d_c, d_r, page);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<F, kSinglePass>;
  // raise the kernel's dynamic shared-memory limit once (grow-only), so a
  // later call inside CUDA-graph capture makes no attribute call
  static int smem_limit = 0;
  if (L.total > smem_limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    smem_limit = L.total;
  }
  const dim3 grid((H + kHeads - 1) / kHeads, num_splits, B);
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q_c8), q_r, sigma_q, static_cast<const T*>(content),
      static_cast<const __nv_bfloat16*>(rope), scale, page_table, seq_lens, o_part, lse_part,
      sp_part, H, d_c, d_r, page, P, pages_per_split, softmax_scale, L);
  return cudaGetLastError();
}

// C: o = sum_s w_s o_s / sum_s w_s with w_s = exp(lse_s - max_s lse),
// lse = max + log(sum_s w_s); one block per (head, batch row).
// Bound: it reads S*H*d_c*4 partial bytes and writes H*d_c*4 per row.
__global__ void lse_combine_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ lse_part, float* __restrict__ o,
                                   float* __restrict__ lse, int S, int H, int d_c) {
  extern __shared__ float w_s[];
  const int h = blockIdx.x, b = blockIdx.y;
  const float* lp = lse_part + static_cast<size_t>(b) * S * H + h;
  float m = lp[0];
  for (int s = 1; s < S; ++s) m = fmaxf(m, lp[static_cast<size_t>(s) * H]);
  float den = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(lp[static_cast<size_t>(s) * H] - m);
    den += w;
    if (threadIdx.x == 0) w_s[s] = w;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < d_c; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < S; ++s)
      num += w_s[s] * o_part[((static_cast<size_t>(b) * S + s) * H + h) * d_c + d];
    o[(static_cast<size_t>(b) * H + h) * d_c + d] = num / den;
  }
  if (threadIdx.x == 0) lse[static_cast<size_t>(b) * H + h] = m + logf(den);
}

}  // namespace snap

extern "C" int snapmla_paged_decode(int fmt, int single_pass, const void* q_c8,
                                    const void* q_r, const void* sigma_q, const void* content,
                                    const void* rope, const void* scale,
                                    const void* page_table, const void* seq_lens,
                                    void* o_part, void* lse_part, void* sp_part, int B,
                                    int H, int d_c, int d_r, int page, int P, int num_splits,
                                    int pages_per_split, float softmax_scale, void* stream) {
  using namespace snap;
  if (d_c % 4 || d_r % 2 || page < kThreads / 32 || page > kThreads || kThreads % page ||
      d_c > kThreads * kMaxDcPerThread || num_splits < 1 ||
      (single_pass && num_splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qr = static_cast<const float*>(q_r);
  const auto* sq = static_cast<const float*>(sigma_q);
  const auto* sc = static_cast<const float*>(scale);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto* op = static_cast<float*>(o_part);
  auto* lp = static_cast<float*>(lse_part);
  auto* spp = static_cast<float*>(sp_part);
  auto st = static_cast<cudaStream_t>(stream);
#define SNAP_DECODE(F, SP)                                                                    \
  launch_decode<F, SP>(q_c8, qr, sq, content, rope, sc, pt, sl, op, lp, spp, B, H, d_c, d_r, \
                       page, P, num_splits, pages_per_split, softmax_scale, st)
  cudaError_t err;
  switch (fmt) {
    case kFp8: err = single_pass ? SNAP_DECODE(kFp8, true) : SNAP_DECODE(kFp8, false); break;
    case kInt8: err = single_pass ? SNAP_DECODE(kInt8, true) : SNAP_DECODE(kInt8, false); break;
    case kNone: err = single_pass ? SNAP_DECODE(kNone, true) : SNAP_DECODE(kNone, false); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SNAP_DECODE
  return static_cast<int>(err);
}

extern "C" int snapmla_lse_combine(const void* o_part, const void* lse_part, void* o, void* lse,
                                   int B, int S, int H, int d_c, void* stream) {
  using namespace snap;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  lse_combine_kernel<<<grid, 128, S * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse_part),
      static_cast<float*>(o), static_cast<float*>(lse), S, H, d_c);
  return static_cast<int>(cudaGetLastError());
}
