// SnapMLA FP8 decode for Hopper (sm_90a): the scale-fused split-KV kernel over
// a paged pool or a contiguous cache, its single-pass mode, its AMLA mode, the
// LSE combine and the AMLA combine.
//
// Replaces (the reference JAX package, Pallas on TPU):
//   A  paged split-KV decode   repro/kernels/mla_decode/kernel.py:
//        mla_decode_paged_splitkv_pallas (_paged_splitkv_body ->
//        _mla_decode_splitkv_kernel -> _block_pipeline, q_len = 1)
//   B  paged single pass       kernel.py: mla_decode_paged_pallas
//        (_paged_body -> _mla_decode_kernel): the same kernel compiled with
//        kSinglePass = true
//   #2 contiguous split-KV     kernel.py: mla_decode_splitkv_pallas — kernel A
//        with contiguous block addressing (page_table == nullptr)
//   #1 contiguous single pass  kernel.py: mla_decode_pallas — kernel B with
//        contiguous block addressing
//   C  LSE combine             kernel.py: lse_combine_pallas (_lse_combine_kernel)
//   #4 AMLA combine            kernel.py: amla_combine_pallas (_amla_combine_kernel)
// and every decode kernel in both rescale modes of _block_pipeline: "fma"
// (kAmla = false) and "amla" (kAmla = true, kernel.py:152-177).
//
// Design. One block of 512 threads per (head tile of kHeads heads, split,
// batch row); the block walks its split's KV blocks in order (the sigma_p
// scale chain needs monotone order, kernel.py:27-38). KV block g of row b is
// block page_table[b, g] of the pool, or block b*P + g of a contiguous
// [B, P*bn, .] cache — the same address with the identity table, so the
// paged and contiguous kernels run one code path and agree bit for bit when
// block_n equals the page. Per block it stages content, rope and scale in
// shared memory, then
//   1. s = (q_c8.C + q_r.R) * (sigma_q x sigma_k) * scale, masked to
//      tok < seq_len with the -1e30 sentinel. A group of lanes per token
//      widens the token's content once for all heads of the tile. Both dots
//      accumulate in float64 and round once to float32: a product of two fp8
//      values is exact, so the content dot is exact in any order and the
//      kernel agrees bit for bit with the plain PyTorch version (ref.py) —
//      which matters because P's fp8 rounding below flips on a one-ulp
//      change of a logit;
//   2. online softmax (one warp per head). FMA: m_new, e = exp(s - m_new),
//      p~ = e * sigma_k, sigma_p = max(max|p~|, EPS)/qmax over exactly one
//      block, P8 = fp8(p~ / sigma_p), corr = exp(m_prev - m_new) *
//      sigma_p_prev / sigma_p, l = l*corr + sum(e)/sigma_p. AMLA: the max and
//      sigma_p on the power-of-two grid, i_new = max(i_prev, ceil(max s *
//      log2 e)), e = exp(s - i_new*ln2), sigma_p = 2^e_new with e_new =
//      ceil(log2(max(max|p~|, EPS)/qmax)), P8 = fp8(p~ * 2^-e_new), and the
//      rescale 2^k, k = (i_prev - i_new) + (e_prev - e_new) (0 while l == 0),
//      applied by an integer add on the exponent bits (exp2_mul);
//   3. acc = acc*corr + P8.C (AMLA: exp2_mul(acc, k) + P8.C), the
//      accumulator in registers.
// Every product and sum whose rounding the plain version fixes is written
// with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract it into an
// FMA. Split mode skips dead blocks (g*bn >= seq_len: neither loaded nor
// computed) and publishes, for an empty split, (0, -1e30, sigma_p = 1) in FMA
// mode and (0, 0, 0) in AMLA mode, whose split partials are the raw
// (acc, l, g = i + e). Single-pass mode has no early exit: a dead block runs
// the sigma_p update with an all-masked block (sigma_p floors at EPS/qmax);
// its loads are elided because masked entries contribute exact zeros.
//
// P-Cast sink guard (contiguous caches): on rows tok < S_k the content value
// is sink[b, tok] / max(scale[b, tok], FLT_MIN), computed in float32 with
// IEEE division — the value repro/core/kvcache.py:sink_patched_content gives
// the reference kernel — read from the small [B, S_k, d_c] float32 shadow in
// place of a whole float32 copy of the cache. Only blocks holding such rows
// select those values (step 1) and take a one-token-at-a-time path (step 3);
// a launch without a sink runs an instantiation compiled without these paths
// (kSink = false), so the unguarded kernels keep their schedule.
//
// Bound on the H100: 644 bytes per live token (512 fp8 content + 128 bf16
// rope + 4 scale) at 3.35 TB/s, i.e. memory-bound at the card's rates. This
// simple version is far from that bound: the float64 QK dot and the conversions
// run on the CUDA cores, each head tile re-reads its block (from L2), and the
// loads are not overlapped with compute. Left for later: fp8 wgmma for QK and
// PV with an exactness-preserving accumulation, TMA block loads in a ring of
// shared-memory stages, all heads of a row in one warp-specialised block, and
// the combine folded into the split kernel's epilogue.
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
static Layout layout(int d_c, int d_r, int bn) {
  Layout L;
  const int esize = sizeof(typename Format<F>::T);
  const int tpt = kThreads / bn;
  L.c_row_words = padded_row_words(d_c * esize / 4, tpt);
  L.r_row_words = padded_row_words(d_r / 2, tpt);
  int off = 0;
  L.q = take(off, kHeads * d_c * 8);
  L.qr = take(off, kHeads * d_r * 8);
  L.c = take(off, bn * L.c_row_words * 4);
  L.r = take(off, bn * L.r_row_words * 4);
  L.sk = take(off, bn * 4);
  L.p = take(off, kHeads * bn * 4);
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

// Add one content word's values (widened to float64) times the query of every
// head of the tile: ac[h] += q[h, w*N + e] * cv[e], in that order.
template <int N>
__device__ __forceinline__ void qk_word(double (&ac)[kHeads], const double* q, const double (&cv)[N],
                                        int d_c, int nh) {
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      if (h < nh) ac[h] = fma(q[h * d_c + e], cv[e], ac[h]);
}

// The sink guard's full-precision content value of row tok (< S_k).
__device__ __forceinline__ float sink_value(const float* __restrict__ sink, int b, int S_k,
                                            int tok, int d, int d_c, float scale) {
  return __fdiv_rn(sink[(static_cast<size_t>(b) * S_k + tok) * d_c + d], fmaxf(scale, kTiny));
}

template <int F, bool kSinglePass, bool kAmla, bool kSink>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const typename Format<F>::T* __restrict__ q_c8,
              const float* __restrict__ q_r, const float* __restrict__ sigma_q,
              const typename Format<F>::T* __restrict__ content,
              const __nv_bfloat16* __restrict__ rope, const float* __restrict__ scale,
              const int* __restrict__ page_table, const int* __restrict__ seq_lens,
              const float* __restrict__ sink, int S_k, float* __restrict__ o_part,
              float* __restrict__ lse_part, float* __restrict__ sp_part, int H, int d_c,
              int d_r, int bn, int P, int blocks_per_split, float softmax_scale, Layout L) {
  using Fm = Format<F>;
  using T = typename Fm::T;
  extern __shared__ __align__(16) unsigned char smem[];
  double* q_s = reinterpret_cast<double*>(smem + L.q);
  double* qr_s = reinterpret_cast<double*>(smem + L.qr);
  uint32_t* c_s = reinterpret_cast<uint32_t*>(smem + L.c);
  uint32_t* r_s = reinterpret_cast<uint32_t*>(smem + L.r);
  float* sk_s = reinterpret_cast<float*>(smem + L.sk);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.state);  // FMA: m; AMLA: i
  float* l_s = m_s + kHeads;
  float* sp_s = l_s + kHeads;                              // FMA: sigma_p; AMLA: e
  float* corr_s = sp_s + kHeads;                           // FMA: corr
  int* k_s = reinterpret_cast<int*>(corr_s);               // AMLA: k

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * kHeads;
  const int nh = min(kHeads, H - h0);
  const int split = blockIdx.y, S = gridDim.y;
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const size_t row0 = static_cast<size_t>(b) * H + h0;

  for (int i = tid; i < nh * d_c; i += kThreads) q_s[i] = Fm::widen(q_c8[row0 * d_c + i]);
  const int tpt = kThreads / bn;  // lanes per token in step 1 (power of two, <= 32)
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
  const int first = split * blocks_per_split;
  const int last = min(first + blocks_per_split, P);
  for (int g = first; g < last; ++g) {
    const bool live = g * bn < seq_len;
    if (!kSinglePass && !live) break;  // early exit: valid tokens are a prefix
    if (live) {
      const size_t pid = page_table != nullptr
                             ? static_cast<size_t>(page_table[static_cast<size_t>(b) * P + g])
                             : static_cast<size_t>(b) * P + g;
      const uint32_t* src_c = reinterpret_cast<const uint32_t*>(content + pid * bn * d_c);
      for (int i = tid; i < bn * c_words; i += kThreads) {
        const int t = i / c_words;
        c_s[t * L.c_row_words + (i - t * c_words)] = src_c[i];
      }
      const uint32_t* src_r = reinterpret_cast<const uint32_t*>(rope + pid * bn * d_r);
      for (int i = tid; i < bn * r_words; i += kThreads) {
        const int t = i / r_words;
        r_s[t * L.r_row_words + (i - t * r_words)] = src_r[i];
      }
      for (int t = tid; t < bn; t += kThreads) sk_s[t] = scale[pid * bn + t];
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
        const int tok = g * bn + t;
        const bool valid = tok < seq_len;
        double ac[kHeads], ar[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) ac[h] = ar[h] = 0.0;
        if (valid) {
          const uint32_t* crow = c_s + t * L.c_row_words;
          if (kSink && g * bn < S_k) {  // a block holding sink rows (one branch per block)
            const bool guarded = tok < S_k;  // a sink guard row: the full-precision latent
            for (int w = j; w < c_words; w += tpt) {
              double cv[U::kPerWord];
              U::run(crow[w], cv);
              if (guarded) {  // only the values diverge; the FMAs stay converged
#pragma unroll
                for (int e = 0; e < U::kPerWord; ++e)
                  cv[e] = sink_value(sink, b, S_k, tok, w * U::kPerWord + e, d_c, sk_s[t]);
              }
              qk_word<U::kPerWord>(ac, q_s + w * U::kPerWord, cv, d_c, nh);
            }
          } else {
            for (int w = j; w < c_words; w += tpt) {
              double cv[U::kPerWord];
              U::run(crow[w], cv);
              qk_word<U::kPerWord>(ac, q_s + w * U::kPerWord, cv, d_c, nh);
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
              s = __fadd_rn(static_cast<float>(ac[h]), static_cast<float>(ar[h]));
              s = __fmul_rn(__fmul_rn(s, __fmul_rn(sigma_q[row0 + h], sk_s[t])), softmax_scale);
            }
            p_s[h * bn + t] = s;
          }
        }
      }
    } else {
      for (int i = tid; i < nh * bn; i += kThreads) p_s[i] = kNegInf;
    }
    __syncthreads();

    // 2. online softmax + scale fusion + block-wise dynamic P quantization
    for (int h = warp; h < nh; h += kWarps) {
      float* ph = p_s + h * bn;
      const float m_prev = m_s[h], l_prev = l_s[h], sp_prev = sp_s[h];
      float mx = kAmla ? kNegInf : m_prev;
      for (int t = lane; t < bn; t += 32) mx = fmaxf(mx, ph[t]);
      mx = warp_max(mx);
      // FMA: the running max; AMLA: the max snapped up onto the log2 grid
      const float m_new = kAmla ? fmaxf(m_prev, ceilf(__fmul_rn(mx, kLog2e))) : mx;
      const float shift = kAmla ? __fmul_rn(m_new, kLn2) : m_new;
      float amax = 0.f, esum = 0.f;
      for (int t = lane; t < bn; t += 32) {
        const bool valid = g * bn + t < seq_len;
        const float e = valid ? expf(__fsub_rn(ph[t], shift)) : 0.f;
        const float pf = valid ? __fmul_rn(e, sk_s[t]) : 0.f;  // Key Step 2: fuse sigma_k into P
        esum += e;
        amax = fmaxf(amax, fabsf(pf));
        ph[t] = pf;
      }
      amax = warp_max(amax);
      esum = warp_sum(esum);
      if constexpr (kAmla) {
        float e_new = 0.f;  // "none": scale-fused but unquantized P, sigma_p = 2^0
        if constexpr (F != kNone) {
          e_new = pow2_scale_exponent<F>(amax);
          const float inv = pow2i(-static_cast<int>(e_new));  // exact power of two
          for (int t = lane; t < bn; t += 32) ph[t] = Fm::widen(Fm::cast(__fmul_rn(ph[t], inv)));
        }
        if (lane == 0) {
          // l_prev == 0: no state yet, k pinned to 0 (the sentinel i_prev
          // never reaches the integer conversion)
          const int k = l_prev > 0.f ? static_cast<int>(__fadd_rn(__fsub_rn(m_prev, m_new),
                                                                  __fsub_rn(sp_prev, e_new)))
                                     : 0;
          l_s[h] = __fadd_rn(exp2_mul(l_prev, k), exp2_mul(esum, -static_cast<int>(e_new)));
          m_s[h] = m_new;
          sp_s[h] = e_new;
          k_s[h] = k;
        }
      } else {
        float sp_new = 1.f;  // "none": scale-fused but unquantized P
        if constexpr (F != kNone) {
          sp_new = dynamic_scale<F>(amax);
          for (int t = lane; t < bn; t += 32) ph[t] = Fm::widen(Fm::cast(ph[t] / sp_new));
        }
        if (lane == 0) {
          const float corr = __fmul_rn(expf(__fsub_rn(m_prev, m_new)), sp_prev / sp_new);  // Eq. 12/13
          l_s[h] = __fadd_rn(__fmul_rn(l_prev, corr), esum / sp_new);
          m_s[h] = m_new;
          sp_s[h] = sp_new;
          corr_s[h] = corr;
        }
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
          // the block's sink rows (tok < S_k), rounded up to 4, one token at
          // a time; the rest four at a time (the same order of sums)
          const int t_fast = kSink ? min(bn, max(0, S_k - g * bn + 3) / 4 * 4) : 0;
          for (int t = 0; kSink && t < t_fast; ++t) {
            const int tok = g * bn + t;
            const float c = tok < S_k ? sink_value(sink, b, S_k, tok, d, d_c, sk_s[t])
                                      : Fm::widen(*reinterpret_cast<const T*>(col + t * c_row_bytes));
#pragma unroll
            for (int h = 0; h < kHeads; ++h)
              if (h < nh) pv[h] = fmaf(p_s[h * bn + t], c, pv[h]);
          }
          for (int t = t_fast; t < bn; t += 4) {  // bn % 4 == 0: float4 reads of P
            const unsigned char* ct = col + t * c_row_bytes;
            const float c0 = Fm::widen(*reinterpret_cast<const T*>(ct));
            const float c1 = Fm::widen(*reinterpret_cast<const T*>(ct + c_row_bytes));
            const float c2 = Fm::widen(*reinterpret_cast<const T*>(ct + 2 * c_row_bytes));
            const float c3 = Fm::widen(*reinterpret_cast<const T*>(ct + 3 * c_row_bytes));
#pragma unroll
            for (int h = 0; h < kHeads; ++h) {
              if (h < nh) {
                const float4 p4 = *reinterpret_cast<const float4*>(p_s + h * bn + t);
                pv[h] = fmaf(p4.x, c0, pv[h]);
                pv[h] = fmaf(p4.y, c1, pv[h]);
                pv[h] = fmaf(p4.z, c2, pv[h]);
                pv[h] = fmaf(p4.w, c3, pv[h]);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          if (h < nh) {
            acc[h][i] = kAmla ? __fadd_rn(exp2_mul(acc[h][i], k_s[h]), pv[h])
                              : __fadd_rn(__fmul_rn(acc[h][i], corr_s[h]), pv[h]);
          }
        }
      }
    }
    __syncthreads();  // the next block overwrites the staged tiles
  }

  // epilogue. FMA: (acc / l, m + log(sigma_p * l), sigma_p) — sigma_p cancels
  // in o. AMLA single pass: (acc / l, (i + e) ln2 + log l); AMLA split: the
  // raw (acc, l, g = i + e), combined by amla_combine.
  const size_t out0 = (static_cast<size_t>(b) * S + split) * H + h0;
  const bool raw = kAmla && !kSinglePass;
#pragma unroll
  for (int i = 0; i < kMaxDcPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < d_c) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h < nh) {
          const float l = l_s[h];
          float o = raw ? acc[h][i] : acc[h][i] / l;
          if (!kSinglePass && !kAmla && !(l > 0.f)) o = 0.f;  // empty split: neutral partial
          o_part[(out0 + h) * d_c + d] = o;
        }
      }
    }
  }
  if (tid < nh) {
    const float l = l_s[tid];
    if constexpr (kAmla) {
      const float g = __fadd_rn(m_s[tid], sp_s[tid]);
      if (raw) {
        lse_part[out0 + tid] = l;
        sp_part[out0 + tid] = l > 0.f ? g : 0.f;
      } else {
        lse_part[out0 + tid] = __fadd_rn(__fmul_rn(g, kLn2), logf(l));
      }
    } else {
      float lse = __fadd_rn(m_s[tid], logf(__fmul_rn(sp_s[tid], l)));
      if (!kSinglePass && !(l > 0.f)) lse = kNegInf;
      lse_part[out0 + tid] = lse;
      if (sp_part != nullptr) sp_part[out0 + tid] = sp_s[tid];
    }
  }
}

template <int F, bool kSinglePass, bool kAmla, bool kSink>
static cudaError_t launch_decode(const void* q_c8, const float* q_r, const float* sigma_q,
                                 const void* content, const void* rope, const float* scale,
                                 const int* page_table, const int* seq_lens, const float* sink,
                                 int S_k, float* o_part, float* lse_part, float* sp_part, int B,
                                 int H, int d_c, int d_r, int bn, int P, int num_splits,
                                 int blocks_per_split, float softmax_scale, cudaStream_t stream) {
  using T = typename Format<F>::T;
  const Layout L = layout<F>(d_c, d_r, bn);
  if (L.total > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = decode_kernel<F, kSinglePass, kAmla, kSink>;
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
      static_cast<const __nv_bfloat16*>(rope), scale, page_table, seq_lens, sink, S_k, o_part,
      lse_part, sp_part, H, d_c, d_r, bn, P, blocks_per_split, softmax_scale, L);
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

// #4: the combine-free AMLA merge. Split s holds the raw (acc_s, l_s) of
// scale 2^g_s; shift every split with data onto K* = max g_s by exp2_mul
// (an integer exponent add), sum, then one division and one log:
// o = sum acc_s 2^(g_s - K*) / sum l_s 2^(g_s - K*), lse = K* ln2 + log(den).
// One block per (head, batch row). Bound: like C, S*H*(d_c + 2)*4 bytes in.
__global__ void amla_combine_kernel(const float* __restrict__ acc_part,
                                    const float* __restrict__ l_part,
                                    const float* __restrict__ g_part, float* __restrict__ o,
                                    float* __restrict__ lse, int S, int H, int d_c) {
  extern __shared__ int shift_s[];
  const int h = blockIdx.x, b = blockIdx.y;
  const float* lp = l_part + static_cast<size_t>(b) * S * H + h;
  const float* gp = g_part + static_cast<size_t>(b) * S * H + h;
  float k_star = kNegInf;
  for (int s = 0; s < S; ++s)
    if (lp[static_cast<size_t>(s) * H] > 0.f) k_star = fmaxf(k_star, gp[static_cast<size_t>(s) * H]);
  float den = 0.f;
  for (int s = 0; s < S; ++s) {
    const float l = lp[static_cast<size_t>(s) * H];
    const int k = l > 0.f ? static_cast<int>(__fsub_rn(gp[static_cast<size_t>(s) * H], k_star)) : 0;
    den = __fadd_rn(den, exp2_mul(l, k));
    if (threadIdx.x == 0) shift_s[s] = k;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < d_c; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < S; ++s)
      num = __fadd_rn(num, exp2_mul(acc_part[((static_cast<size_t>(b) * S + s) * H + h) * d_c + d],
                                    shift_s[s]));
    o[(static_cast<size_t>(b) * H + h) * d_c + d] = num / den;
  }
  if (threadIdx.x == 0)
    lse[static_cast<size_t>(b) * H + h] = __fadd_rn(__fmul_rn(k_star, kLn2), logf(den));
}

}  // namespace snap

// One entry point for every decode kernel: fmt, single_pass and amla pick
// the template; page_table == nullptr selects contiguous block addressing
// (content [B, P*block, d_c]); sink (with S_k rows) is the contiguous
// cache's sink guard shadow or nullptr.
extern "C" int snapmla_decode(int fmt, int single_pass, int amla, const void* q_c8,
                              const void* q_r, const void* sigma_q, const void* content,
                              const void* rope, const void* scale, const void* page_table,
                              const void* seq_lens, const void* sink, int S_k, void* o_part,
                              void* lse_part, void* sp_part, int B, int H, int d_c, int d_r,
                              int block, int P, int num_splits, int blocks_per_split,
                              float softmax_scale, void* stream) {
  using namespace snap;
  if (d_c % 4 || d_r % 2 || block < kThreads / 32 || block > kThreads || kThreads % block ||
      d_c > kThreads * kMaxDcPerThread || num_splits < 1 ||
      (single_pass && num_splits != 1) || S_k < 0 || (S_k > 0 && sink == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qr = static_cast<const float*>(q_r);
  const auto* sq = static_cast<const float*>(sigma_q);
  const auto* sc = static_cast<const float*>(scale);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* sl = static_cast<const int*>(seq_lens);
  const auto* sk = static_cast<const float*>(sink);
  auto* op = static_cast<float*>(o_part);
  auto* lp = static_cast<float*>(lse_part);
  auto* spp = static_cast<float*>(sp_part);
  auto st = static_cast<cudaStream_t>(stream);
#define SNAP_DECODE(F, SP, AM)                                                              \
  (S_k > 0 ? SNAP_LAUNCH(F, SP, AM, true) : SNAP_LAUNCH(F, SP, AM, false))
#define SNAP_LAUNCH(F, SP, AM, SK)                                                             \
  launch_decode<F, SP, AM, SK>(q_c8, qr, sq, content, rope, sc, pt, sl, sk, S_k, op, lp, spp, \
                           B, H, d_c, d_r, block, P, num_splits, blocks_per_split,        \
                           softmax_scale, st)
#define SNAP_MODES(F)                                                        \
  (amla ? (single_pass ? SNAP_DECODE(F, true, true) : SNAP_DECODE(F, false, true)) \
        : (single_pass ? SNAP_DECODE(F, true, false) : SNAP_DECODE(F, false, false)))
  cudaError_t err;
  switch (fmt) {
    case kFp8: err = SNAP_MODES(kFp8); break;
    case kInt8: err = SNAP_MODES(kInt8); break;
    case kNone: err = SNAP_MODES(kNone); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SNAP_MODES
#undef SNAP_DECODE
#undef SNAP_LAUNCH
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

extern "C" int snapmla_amla_combine(const void* acc_part, const void* l_part,
                                    const void* g_part, void* o, void* lse, int B, int S, int H,
                                    int d_c, void* stream) {
  using namespace snap;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  amla_combine_kernel<<<grid, 128, S * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(l_part),
      static_cast<const float*>(g_part), static_cast<float*>(o), static_cast<float*>(lse), S, H,
      d_c);
  return static_cast<int>(cudaGetLastError());
}
