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
// (kAmla = false) and "amla" (kAmla = true, kernel.py:152-177), and the
// q_len > 1 verify mode of A and #2 (kVerify = true, kernel.py:381-399).
// Every decode kernel also takes Fused-Q-Quant (D, csrc/q_quant.cu) in its
// prologue, the FMA split kernels take C in their epilogue and the AMLA split
// kernels #4, so a decode step makes one attention launch per layer (below).
//
// Design. One block of 512 threads per (head tile of W heads, split, batch
// row); the block walks its split's KV blocks in order (the sigma_p scale
// chain needs monotone order, kernel.py:27-38). KV block g of row b is block
// page_table[b, g] of the pool, or block b*P + g of a contiguous [B, P*bn, .]
// cache — the same address with the identity table, so the paged and
// contiguous kernels run one code path and agree bit for bit when block_n
// equals the page.
//
// Schedule. The head-tile width W is a template parameter (kWide = 8 and
// kNarrow); the wrapper picks it per launch so that B x ceil(H / W) x
// splits blocks cover the SMs with the fewest re-reads of each KV block from
// L2 (kernel.py::head_width). The width only decides which block computes a
// head: every sum below runs per head, in the same order, at every width, so
// the outputs are bit-identical across widths. The KV blocks are staged
// through a ring of D shared-memory stages: each stage holds one block's
// content, rope and scales in the padded row layout, filled by cp.async
// copies of 16 bytes (8 or 4 where a row or its padded stride is not a
// multiple of 16), one commit group per block. Blocks g + 1 .. g + D - 1 are
// in flight while block g computes; a block's stage is refilled only after
// the barrier that closes the block that last read it. Dead blocks issue no
// copies (an empty group keeps the count), so no step waits on a stage that
// was never filled. D is the deepest ring that fits (at most kMaxStages; 2
// at block 128 in fp8) — unless the grid has more blocks than SMs and the
// kernel's registers allow two blocks per SM (the narrow tile): then the
// deepest ring that lets two blocks share an SM (1 at block 128 in fp8), so
// one block's loads and latencies overlap the other's compute.
//
// Per block, on the staged tiles:
//   0. the prologue, while the first stages load: the tile's query rows into
//      shared memory as float64 and their sigma_q. A prepared query (q_c8,
//      q_r, sigma_q from D or prepare_q) is widened as it is; a raw one
//      (q_lat, q_rope in float32, selected at run time by q_lat != nullptr,
//      fp8 / int8 only) is quantized here by the whole block with D's
//      operations (q_quant.cu): sigma_q = max(max|q_lat|, EPS) / qmax (the
//      max per warp by shuffles, then over the warps by a shared atomicMax
//      on the bits — a max of non-negative floats is exact in any order),
//      q = widen(cast(q_lat / sigma_q)), q_r = q_rope / sigma_q, each by an
//      IEEE division, so the bits are D's. Each split block of a tile
//      quantizes the same W rows again: W x (d_c + d_r) values, about 1 us
//      of a width-8 block, which a grid of several waves of width-8 blocks
//      pays once per wave;
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
//      accumulator in registers;
//   4. the epilogue publishes the split's partial; in split mode with an
//      output (o != nullptr) the tile's S split blocks then merge their
//      partials by a last-block reduction (C or #4 folded, below).
// Every product and sum whose rounding the plain version fixes is written
// with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract it into an
// FMA. Split mode skips dead blocks (g*bn >= seq_len: neither loaded nor
// computed) and publishes, for an empty split, (0, -1e30, sigma_p = 1) in FMA
// mode and (0, 0, 0) in AMLA mode, whose split partials are the raw
// (acc, l, g = i + e). Single-pass mode has no early exit: a dead block runs
// the sigma_p update with an all-masked block (sigma_p floors at EPS/qmax);
// its loads are elided because masked entries contribute exact zeros.
//
// C and #4 folded (the ticket epilogue). Each split block publishes its
// partial as the unfolded kernel does; after a barrier one thread draws a
// ticket from the (row, head tile)'s int32 counter by an atomic add with
// acquire-release semantics at GPU scope (the release covers the block's
// partial, the acquire the partials of the tickets drawn before). The block
// that draws S - 1 reads the S partials of its tile back from L2 (ld.cg: L1
// is not coherent across SMs), merges them per head and latent column in
// split order 0 .. S - 1 with the standalone combine's own routines — C's
// lse_merge under FMA; under AMLA #4's amla_head (one warp per head puts the
// head's K*, den and S shifts in shared memory, which the block no longer
// needs) and amla_merge (each thread's columns) — every add, multiply and
// division written as __fadd_rn / __fmaf_rn / __fdiv_rn so the two call
// sites cannot be contracted apart, writes o and lse, and resets its
// counter to 0 for the next launch. So the folded output is A then C, or A
// then #4, bit for bit. At S = 1 no other block holds a partial of the tile:
// no ticket, and the split writes o and lse straight into the outputs, whose
// layout is the partials' at S = 1. Under FMA that is the partial itself (C's
// merge of one partial is the identity: w = exp(0) = 1, den = 1, o * 1 / 1 =
// o, lse + log 1 = lse; a partial is never -0 or NaN). Under AMLA #4's merge
// of one partial is not the identity (exp2_mul(x, 0) flushes a subnormal x,
// and +0 + -0 = +0), so the block runs it on its registers (amla_single).
// Every block reaches the ticket: there is no early return, and a dead split
// publishes (0, -1e30) (AMLA: (0, 0, 0)) and draws its ticket like any other.
// Why not a thread block cluster merging through distributed shared memory:
// a cluster barrier would hold a dead or short split's block on its SM until
// its longest sibling ends, and an explicit split count
// (ops.resolve_num_splits clamps it only to the block count) can exceed the
// portable cluster size of 8. A caller that wants the partials keeps C or #4
// after the kernel.
//
// q_len > 1 verify mode (split mode only; A and #2 take rank-4 queries
// [B, q_len, H, .] flattened head-major to R = q_len*H rows, row = t*H + h,
// and the wrappers pass R as the kernel's head count). Row t attends tokens
// < seq_len - (q_len - 1) + t, so each row of a head tile carries its own limit
// (a tile of W rows straddles positions when H < W). The block-level early
// exit still uses seq_len. A row with no valid token in a live block keeps
// its state exactly (the reference's row_guard): its sigma_p (FMA) or e
// (AMLA) is pinned to the carried value, so its rescale is exactly 1 or 2^0
// and its P entries are exact zeros; a row with no valid token in a split
// publishes the empty partial. The mask and the guard are compiled only into
// the kVerify instantiations, so q_len = 1 launches run the kernels compiled
// without them. Building with -DSNAPMLA_NO_VERIFY leaves the verify
// instantiations out altogether (the q_len = 1 kernels are the same code).
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
// version is still far from it: per block, the float64 QK dot (W x 73,728
// DFMAs, each reading its query value from shared memory) and the PV run on
// the CUDA cores, about 55% and 34% of a width-8 block's time, while the
// staged loads are 4-20% (H100 runs with parts of the kernel switched off);
// each head tile re-reads its block from L2. Left for later: fp8 wgmma for QK
// and PV with an exactness-preserving accumulation (P's fp8 rounding flips
// on a one-ulp change of a logit); the fp8 / int8 content dot, exact in
// float64 in any order, register-blocked over tokens and heads; warp
// specialisation (a producer warp issuing TMA loads, consumer warpgroups).
#include "common.cuh"
#include "mla_merge.cuh"

namespace snap {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDc = 1024;               // the largest latent width taken
constexpr int kCols = 2;                   // latent columns per thread in step 3
static_assert(kThreads * kCols >= kMaxDc, "step 3 covers every column");
constexpr int kMaxStages = 4;              // shared-memory stages of the KV ring
static_assert(kMaxStages <= 4, "cp_async_wait waits for at most 3 pending groups");
constexpr int kSmemLimit = 227 * 1024;     // dynamic shared memory of one block
constexpr int kSmemPerSm = 228 * 1024;     // of one SM, for all its blocks
constexpr int kSmemReserved = 1024;        // the system's share of each block
constexpr int kRegsPerSm = 65536;
// head-tile widths (heads per block), instantiated for every mode; the
// wrapper's HEAD_WIDTHS (kernels/mla_decode/kernel.py) lists the same two
constexpr int kWide = 8;
constexpr int kNarrow = 1;
// the most splits a folded AMLA launch takes: its shift table (one int per
// head and split) must fit one block's shared memory at width 8; the wrapper
// sends a call with more to the kernel then the standalone #4 (kernel.py:
// AMLA_FOLD_MAX_SPLITS)
constexpr int kMaxAmlaFoldSplits = 4096;

// byte offsets into the dynamic shared memory of one block; c, r and sk are
// offsets inside a stage, the ring's stage i starting at stage + i*stage_bytes
struct Layout {
  int q, qr, p, state, stage, stage_bytes, stages, total;
  int c, r, sk;
  int c_row_words, r_row_words;
  int c_chunk, r_chunk, sk_chunk;  // bytes per cp.async copy (16, 8 or 4)
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

template <int F, int W>
static Layout layout(int d_c, int d_r, int bn, int stages) {
  Layout L;
  const int esize = sizeof(typename Format<F>::T);
  const int tpt = kThreads / bn;
  L.c_row_words = padded_row_words(d_c * esize / 4, tpt);
  L.r_row_words = padded_row_words(d_r / 2, tpt);
  int off = 0;
  L.q = take(off, W * d_c * 8);
  L.qr = take(off, W * d_r * 8);
  L.p = take(off, W * bn * 4);
  L.state = take(off, 5 * W * 4);  // m, l, sigma_p, corr, sigma_q per head
  int s = 0;
  L.c = take(s, bn * L.c_row_words * 4);
  L.r = take(s, bn * L.r_row_words * 4);
  L.sk = take(s, bn * 4);
  L.stage_bytes = s;
  L.stages = stages;
  L.stage = take(off, stages * s);
  L.total = off;
  return L;
}

// The widest cp.async copy (16, 8 or 4 bytes) that divides a row, its
// shared-memory stride and the alignment of its source; 0 if none does.
static int chunk_bytes(int row_bytes, int stride_bytes, const void* src) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  for (int c = 16; c >= 4; c /= 2)
    if (row_bytes % c == 0 && stride_bytes % c == 0 && a % c == 0) return c;
  return 0;
}

// This thread's share of copying `rows` rows of `per_row` pieces, contiguous
// in global memory, into shared rows `stride` bytes apart: pieces tid,
// tid + kThreads, ...; (t0, c0) is piece tid's (row, column) and (dq, dr)
// the step of kThreads pieces, so the walk needs no division per piece.
struct Walk {
  int per_row, t0, c0, dq, dr;
};

__device__ __forceinline__ Walk make_walk(int row_bytes, int chunk) {
  Walk w;
  w.per_row = row_bytes / chunk;
  w.t0 = threadIdx.x / w.per_row;
  w.c0 = threadIdx.x - w.t0 * w.per_row;
  w.dq = kThreads / w.per_row;
  w.dr = kThreads - w.dq * w.per_row;
  return w;
}

template <int N>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const unsigned char* src, int rows,
                                          int stride, const Walk& w) {
  int t = w.t0, c = w.c0;
  for (int i = threadIdx.x; t < rows; i += kThreads) {
    cp_async<N>(dst + t * stride + c * N, src + static_cast<size_t>(i) * N);
    t += w.dq;
    c += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++t;
    }
  }
}

__device__ __forceinline__ void copy_region(int chunk, unsigned char* dst, const unsigned char* src,
                                            int rows, int stride, const Walk& w) {
  if (chunk == 16) copy_rows<16>(dst, src, rows, stride, w);
  else if (chunk == 8) copy_rows<8>(dst, src, rows, stride, w);
  else copy_rows<4>(dst, src, rows, stride, w);
}

// The N (2 or 4) consecutive content values at p of one staged row, widened
// to float (exactly), read as one or two 32-bit words (a 16-bit one for two
// 8-bit values).
template <int F, int N>
__device__ __forceinline__ void widen_cols(const unsigned char* p, float (&c)[N]) {
  if constexpr (F == kNone) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p + 2 * k);
      c[k] = bf16_lo(v);
      c[k + 1] = bf16_hi(v);
    }
  } else {
    const uint32_t v = N == 4 ? *reinterpret_cast<const uint32_t*>(p)
                              : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const uint32_t pair = (v >> (8 * k)) & 0xffffu;
      if constexpr (F == kFp8) {
        const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3)));
        c[k] = f.x;
        c[k + 1] = f.y;
      } else {
        c[k] = static_cast<int8_t>(pair & 0xffu);
        c[k + 1] = static_cast<int8_t>(pair >> 8);
      }
    }
  }
}

// Add one content word's values (widened to float64) times the query of every
// head of the tile: ac[h] += q[h, w*N + e] * cv[e], in that order.
template <int N, int W>
__device__ __forceinline__ void qk_word(double (&ac)[W], const double* q, const double (&cv)[N],
                                        int d_c, int nh) {
#pragma unroll
  for (int e = 0; e < N; ++e)
#pragma unroll
    for (int h = 0; h < W; ++h)
      if (h < nh) ac[h] = fma(q[h * d_c + e], cv[e], ac[h]);
}

// #4's arithmetic. Over the S raw split partials (acc_s, l_s, g_s) of one
// (row, head): K* = the max of g_s over the splits with l_s > 0 (kNegInf if
// none); the shift k_s = g_s - K* (0 where l_s == 0); den = sum_s
// exp2_mul(l_s, k_s) and, per latent column, num = sum_s exp2_mul(acc_s,
// k_s), each summed from +0 in split order; o = num / den and lse = K* ln2 +
// log(den). K*, den and the shifts are a head's, not a column's: one warp
// computes them once per head (amla_head) into shared memory, and every
// thread then merges its columns with them (amla_merge). The standalone #4
// kernel, the split kernels' ticket epilogue and their one-split path
// (amla_single) share these routines, so every call site rounds alike.

// The shift of one split with data in it, and 0 for an empty one.
__device__ __forceinline__ int amla_shift(float l, float g, float k_star) {
  return l > 0.f ? static_cast<int>(__fsub_rn(g, k_star)) : 0;
}

__device__ __forceinline__ float amla_lse(float k_star, float den) {
  return __fadd_rn(__fmul_rn(k_star, kLn2), logf(den));
}

// num[c] += exp2_mul(v_j[c], k_j) for the first n of C splits, in order.
template <int N, int C>
__device__ __forceinline__ void amla_num(float (&num)[N], const float (&v)[C][N],
                                         const int (&k)[C], int n) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j < n)
#pragma unroll
      for (int c = 0; c < N; ++c) num[c] = __fadd_rn(num[c], exp2_mul(v[j][c], k[j]));
}

// K* and den of one head, and its S shifts into k_out[0 .. S): called by a
// whole warp (every lane returns (K*, den)). Lane s takes splits s, s + 32,
// ... (the l_s at lp + s*stride, g_s at gp + s*stride, read from L2); K* is
// a warp max (exact in any order); the terms exp2_mul(l_s, k_s) are added
// in split order by shuffling them to every lane.
__device__ __forceinline__ float2 amla_head(const float* lp, const float* gp, size_t stride,
                                            int S, int* k_out) {
  const int lane = threadIdx.x & 31;
  float l0 = 0.f, g0 = 0.f, k_star = kNegInf;
  if (lane < S) {
    load_l2<1>(lp + lane * stride, &l0);
    load_l2<1>(gp + lane * stride, &g0);
    if (l0 > 0.f) k_star = fmaxf(k_star, g0);
  }
  for (int s = lane + 32; s < S; s += 32) {
    float l, g;
    load_l2<1>(lp + s * stride, &l);
    load_l2<1>(gp + s * stride, &g);
    if (l > 0.f) k_star = fmaxf(k_star, g);
  }
  k_star = warp_max(k_star);
  float den = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    float term = 0.f;
    if (s < S) {
      float l = l0, g = g0;
      if (s0 > 0) {
        load_l2<1>(lp + s * stride, &l);
        load_l2<1>(gp + s * stride, &g);
      }
      const int k = amla_shift(l, g, k_star);
      k_out[s] = k;
      term = exp2_mul(l, k);
    }
    const int n = min(32, S - s0);
    for (int j = 0; j < n; ++j) den = __fadd_rn(den, __shfl_sync(0xffffffffu, term, j));
  }
  return make_float2(k_star, den);
}

// #4's merge of N consecutive latent columns of one head, its shifts k[0 ..
// S) and den from amla_head: the S partials acc_s at ap + s*a_stride, read
// from L2, C splits' loads in flight at once; writes o to out.
template <int N, int C>
__device__ __forceinline__ void amla_merge(const float* ap, size_t a_stride, const int* k, int S,
                                           float den, float (&out)[N]) {
  float num[N];
#pragma unroll
  for (int c = 0; c < N; ++c) num[c] = 0.f;
  for (int s0 = 0; s0 < S; s0 += C) {
    float v[C][N];
    int kc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (s0 + j < S) {
        load_l2<N>(ap + (s0 + j) * a_stride, v[j]);
        kc[j] = k[s0 + j];
      }
    }
    amla_num<N, C>(num, v, kc, S - s0);
  }
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = __fdiv_rn(num[c], den);
}

// #4 on the one raw partial (acc, l, g = i + e) a block holds in registers:
// the folded merge at S = 1, the arithmetic above over one split. It is not
// the identity: exp2_mul(x, 0) flushes a subnormal x to zero and +0 + -0 is
// +0, so o is not acc / l bit for bit (tests/test_torch_amla.py pins the
// plain version's bits at one split).
template <int N>
__device__ __forceinline__ float amla_single(const float (&acc)[N], float l, float g,
                                             float (&out)[N]) {
  const float k_star = l > 0.f ? fmaxf(kNegInf, g) : kNegInf;
  const int k[1] = {amla_shift(l, g, k_star)};
  const float den = __fadd_rn(0.f, exp2_mul(l, k[0]));
  float num[N], v[1][N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    num[c] = 0.f;
    v[0][c] = acc[c];
  }
  amla_num<N, 1>(num, v, k, 1);
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = __fdiv_rn(num[c], den);
  return amla_lse(k_star, den);
}

// The merge of a tile's nh heads (C folded): items of N latent columns of one
// head, spread over the block's threads, C splits' loads in flight at once
// (N x C floats of registers per thread). Not inlined (see quantize_query).
template <int N, int C>
__device__ __noinline__ void merge_tile(const float* o_part, const float* lse_part,
                                           float* o_out, float* lse_out, size_t part0,
                                           size_t row0, int nh, int H, int S, int d_c) {
  const int per_head = d_c / N;
  for (int i = threadIdx.x; i < nh * per_head; i += kThreads) {
    const int h = i / per_head, c = (i - h * per_head) * N;
    float out[N];
    const float l = lse_merge<N, C>(o_part + (part0 + h) * d_c + c,
                                    static_cast<size_t>(H) * d_c, lse_part + part0 + h,
                                    static_cast<size_t>(H), S, out);
    store_cols<N>(o_out + (row0 + h) * d_c + c, out);
    if (c == 0) lse_out[row0 + h] = l;
  }
}

// The merge of a tile's nh heads (#4 folded): one warp per head computes its
// K*, den and S shifts into shared memory (kd: kWide (K*, den) pairs, then
// the shifts, S per head), then items of N latent columns of one head are
// spread over the block's threads as in merge_tile. Not inlined.
template <int N, int C>
__device__ __noinline__ void amla_merge_tile(const float* acc_part, const float* l_part,
                                             const float* g_part, float* o_out, float* lse_out,
                                             size_t part0, size_t row0, int nh, int H, int S,
                                             int d_c, float2* kd) {
  int* shifts = reinterpret_cast<int*>(kd + kWide);
  const int warp = threadIdx.x >> 5;
  for (int h = warp; h < nh; h += kWarps) {
    const float2 r = amla_head(l_part + part0 + h, g_part + part0 + h, H, S, shifts + h * S);
    if ((threadIdx.x & 31) == 0) kd[h] = r;
  }
  __syncthreads();
  const int per_head = d_c / N;
  for (int i = threadIdx.x; i < nh * per_head; i += kThreads) {
    const int h = i / per_head, c = (i - h * per_head) * N;
    const float2 r = kd[h];
    float out[N];
    amla_merge<N, C>(acc_part + (part0 + h) * d_c + c, static_cast<size_t>(H) * d_c,
                     shifts + h * S, S, r.y, out);
    store_cols<N>(o_out + (row0 + h) * d_c + c, out);
    if (c == 0) lse_out[row0 + h] = amla_lse(r.x, r.y);
  }
}

// Step 0 on a raw query (D folded) for a narrow tile: the tile's nh rows of
// q_lat [., d_c] and q_rope [., d_r] from row row0, quantized by the whole
// block into q_s, qr_s (float64) and sq_s; amax_s is W ints of shared
// scratch. Not inlined, like merge_tile: code that runs once per block stays
// out of the register allocation and schedule of the decode loop.
template <int F, int W>
__device__ __noinline__ void quantize_query(const float* __restrict__ q_lat,
                                            const float* __restrict__ q_rope, size_t row0,
                                            int nh, int d_c, int d_r, double* q_s, double* qr_s,
                                            float* sq_s, int* amax_s) {
  using Fm = Format<F>;
  const int tid = threadIdx.x, lane = tid & 31;
  // this thread's latent values (columns tid, tid + kThreads of each head)
  // and the W heads side by side, so their loads, shuffles and divisions
  // overlap; the warps' maxima meet in a shared atomicMax on their bits
  // (a non-negative float orders as its int)
  constexpr int kQCols = kMaxDc / kThreads;
  float qx[W][kQCols];
#pragma unroll
  for (int h = 0; h < W; ++h)
#pragma unroll
    for (int j = 0; j < kQCols; ++j) {
      const int d = tid + j * kThreads;
      qx[h][j] = h < nh && d < d_c ? q_lat[(row0 + h) * d_c + d] : 0.f;
    }
  if (tid < W) amax_s[tid] = 0;
  float amax[W];
#pragma unroll
  for (int h = 0; h < W; ++h) {
    amax[h] = 0.f;
#pragma unroll
    for (int j = 0; j < kQCols; ++j) amax[h] = fmaxf(amax[h], fabsf(qx[h][j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int h = 0; h < W; ++h) amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], o));
  __syncthreads();   // amax_s is zero
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < W; ++h)
      if (h < nh) atomicMax(amax_s + h, __float_as_int(amax[h]));
  }
  __syncthreads();
  float sq[W];
#pragma unroll
  for (int h = 0; h < W; ++h) {
    sq[h] = dynamic_scale<F>(__int_as_float(amax_s[h]));
    if (tid == h && h < nh) sq_s[h] = sq[h];
  }
#pragma unroll
  for (int h = 0; h < W; ++h)
#pragma unroll
    for (int j = 0; j < kQCols; ++j) {
      const int d = tid + j * kThreads;
      if (h < nh && d < d_c) q_s[h * d_c + d] = Fm::widen(Fm::cast(__fdiv_rn(qx[h][j], sq[h])));
    }
  for (int i = tid; i < nh * d_r; i += kThreads)
    qr_s[i] = static_cast<double>(__fdiv_rn(q_rope[row0 * d_r + i],
                                            dynamic_scale<F>(__int_as_float(amax_s[i / d_r]))));
}

// The sink guard's full-precision content value of row tok (< S_k).
__device__ __forceinline__ float sink_value(const float* __restrict__ sink, int b, int S_k,
                                            int tok, int d, int d_c, float scale) {
  return __fdiv_rn(sink[(static_cast<size_t>(b) * S_k + tok) * d_c + d], fmaxf(scale, kTiny));
}

// The narrow tile is compiled for two blocks per SM (at most 64 registers a
// thread at 512 threads), which launch_decode's two-blocks rule assumes:
// unbounded, ptxas may give a split kernel more (an AMLA merge that each
// thread computed whole took the AMLA split kernels to 124 registers, and at
// one block per SM they ran 21% slower at 32k tokens on the H100).
template <int F, int W, bool kSinglePass, bool kAmla, bool kSink, bool kVerify>
__global__ void __launch_bounds__(kThreads, W == kNarrow ? 2 : 1)
decode_kernel(const typename Format<F>::T* __restrict__ q_c8,
              const float* __restrict__ q_r, const float* __restrict__ sigma_q,
              const float* __restrict__ q_lat, const float* __restrict__ q_rope,
              const typename Format<F>::T* __restrict__ content,
              const __nv_bfloat16* __restrict__ rope, const float* __restrict__ scale,
              const int* __restrict__ page_table, const int* __restrict__ seq_lens,
              const float* __restrict__ sink, int S_k, float* o_part, float* lse_part,
              float* __restrict__ sp_part, float* __restrict__ o_out,
              float* __restrict__ lse_out, int* __restrict__ tickets, int H, int d_c,
              int d_r, int bn, int P, int blocks_per_split, float softmax_scale, int q_len,
              Layout L) {
  using Fm = Format<F>;
  using T = typename Fm::T;
  extern __shared__ __align__(16) unsigned char smem[];
  double* q_s = reinterpret_cast<double*>(smem + L.q);
  double* qr_s = reinterpret_cast<double*>(smem + L.qr);
  unsigned char* ring = smem + L.stage;
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.state);  // FMA: m; AMLA: i
  float* l_s = m_s + W;
  float* sp_s = l_s + W;                                   // FMA: sigma_p; AMLA: e
  float* corr_s = sp_s + W;                                // FMA: corr
  int* k_s = reinterpret_cast<int*>(corr_s);               // AMLA: k
  float* sq_s = corr_s + W;                                // sigma_q

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = kCols * tid;  // the first latent column of this thread in step 3
  const int h0 = blockIdx.x * W;
  const int nh = min(W, H - h0);
  const int split = blockIdx.y, S = gridDim.y;
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const size_t row0 = static_cast<size_t>(b) * H + h0;
  // the token limit of row h0 + h; in verify mode it is position
  // (h0 + h) / heads of the q_len block, heads = H / q_len
  auto limit = [&](int h) {
    if constexpr (kVerify) return seq_len - (q_len - 1) + (h0 + h) / (H / q_len);
    else return seq_len;
  };

  const int c_words = d_c * static_cast<int>(sizeof(T)) / 4;  // words per content row
  const int r_words = d_r / 2;
  const int c_row_bytes = L.c_row_words * 4;
  const int first = split * blocks_per_split;
  const int last = min(first + blocks_per_split, P);
  const int D = L.stages;
  // the pool block holding KV block g of row b (g < last)
  auto block_of = [&](int g) -> size_t {
    if (g >= last) return 0;
    return page_table != nullptr ? static_cast<size_t>(page_table[static_cast<size_t>(b) * P + g])
                                 : static_cast<size_t>(b) * P + g;
  };
  // issue the copies of block g, pool block pid (none when g is past the
  // split or dead), into its stage, (g - first) mod D, as one commit group
  auto issue = [&](int g, size_t pid) {
    if (g < last && g * bn < seq_len) {
      const Walk wc = make_walk(c_words * 4, L.c_chunk);
      const Walk wr = make_walk(r_words * 4, L.r_chunk);
      const Walk ws = make_walk(bn * 4, L.sk_chunk);
      unsigned char* st = ring + ((g - first) % D) * L.stage_bytes;
      copy_region(L.c_chunk, st + L.c,
                  reinterpret_cast<const unsigned char*>(content + pid * bn * d_c), bn,
                  c_row_bytes, wc);
      copy_region(L.r_chunk, st + L.r,
                  reinterpret_cast<const unsigned char*>(rope + pid * bn * d_r), bn,
                  L.r_row_words * 4, wr);
      copy_region(L.sk_chunk, st + L.sk,
                  reinterpret_cast<const unsigned char*>(scale + pid * bn), 1, 0, ws);
    }
    cp_async_commit();
  };
  for (int k = 0; k < D - 1; ++k) issue(first + k, block_of(first + k));  // in flight during the set-up
  size_t pid_ahead = block_of(first + D - 1);

  // 0. the tile's query rows and sigma_q: a raw query quantized here with
  // D's operations (every thread of the block on every head: max|q_lat| per
  // warp, then over the warps — a max is exact in any order — then the
  // scaled casts), a prepared one widened
  if (q_lat != nullptr) {
    if constexpr (F != kNone && W >= 4) {
      // a wide tile: one warp per head
      for (int h = warp; h < nh; h += kWarps) {
        const float* src = q_lat + (row0 + h) * d_c;
        float amax = 0.f;
        for (int d = lane; d < d_c; d += 32) amax = fmaxf(amax, fabsf(src[d]));
        const float sq = dynamic_scale<F>(warp_max(amax));
        for (int d = lane; d < d_c; d += 32)
          q_s[h * d_c + d] = Fm::widen(Fm::cast(__fdiv_rn(src[d], sq)));
        const float* rsrc = q_rope + (row0 + h) * d_r;
        for (int k = lane; k < d_r; k += 32)
          qr_s[h * d_r + k] = static_cast<double>(__fdiv_rn(rsrc[k], sq));
        if (lane == 0) sq_s[h] = sq;
      }
    } else if constexpr (F != kNone) {
      // a narrow tile: the whole block on its heads
      quantize_query<F, W>(q_lat, q_rope, row0, nh, d_c, d_r, q_s, qr_s, sq_s,
                           reinterpret_cast<int*>(p_s));   // p_s is free until step 1
    }
  } else {
    for (int i = tid; i < nh * d_c; i += kThreads) q_s[i] = Fm::widen(q_c8[row0 * d_c + i]);
    for (int i = tid; i < nh * d_r; i += kThreads) qr_s[i] = static_cast<double>(q_r[row0 * d_r + i]);
    if (tid < nh) sq_s[tid] = sigma_q[row0 + tid];
  }
  const int tpt = kThreads / bn;  // lanes per token in step 1 (power of two, <= 32)
  if (tid < W) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    sp_s[tid] = 1.f;
  }
  float acc[W][kCols];
#pragma unroll
  for (int h = 0; h < W; ++h)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[h][k] = 0.f;
  __syncthreads();

  for (int g = first; g < last; ++g) {
    const bool live = g * bn < seq_len;
    if (!kSinglePass && !live) break;  // early exit: valid tokens are a prefix
    // refill the stage that block g - 1 read (its readers have passed the
    // barrier that closed block g - 1); the page of the next refill is read
    // now, one block ahead of its use
    const size_t pid = pid_ahead;
    pid_ahead = block_of(g + D);
    issue(g + D - 1, pid);
    unsigned char* st = ring + ((g - first) % D) * L.stage_bytes;
    const uint32_t* c_s = reinterpret_cast<const uint32_t*>(st + L.c);
    const uint32_t* r_s = reinterpret_cast<const uint32_t*>(st + L.r);
    const float* sk_s = reinterpret_cast<const float*>(st + L.sk);
    if (live) {
      cp_async_wait(D - 1);  // this thread's copies of block g have landed ...
      __syncthreads();       // ... and every thread's
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
        double ac[W], ar[W];
#pragma unroll
        for (int h = 0; h < W; ++h) ac[h] = ar[h] = 0.0;
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
              qk_word<U::kPerWord, W>(ac, q_s + w * U::kPerWord, cv, d_c, nh);
            }
          } else {
            for (int w = j; w < c_words; w += tpt) {
              double cv[U::kPerWord];
              U::run(crow[w], cv);
              qk_word<U::kPerWord, W>(ac, q_s + w * U::kPerWord, cv, d_c, nh);
            }
          }
          const uint32_t* rrow = r_s + t * L.r_row_words;
          for (int w = j; w < r_words; w += tpt) {
            const uint32_t v = rrow[w];
            const double r0 = bf16_lo(v), r1 = bf16_hi(v);
#pragma unroll
            for (int h = 0; h < W; ++h) {
              if (h < nh) {
                ar[h] = fma(qr_s[h * d_r + 2 * w], r0, ar[h]);
                ar[h] = fma(qr_s[h * d_r + 2 * w + 1], r1, ar[h]);
              }
            }
          }
        }
        for (int o = tpt / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < W; ++h) {
            ac[h] += __shfl_xor_sync(0xffffffffu, ac[h], o);
            ar[h] += __shfl_xor_sync(0xffffffffu, ar[h], o);
          }
        }
#pragma unroll
        for (int h = 0; h < W; ++h) {
          if (h < nh && (h & (tpt - 1)) == j) {
            float s = kNegInf;
            if (kVerify ? tok < limit(h) : valid) {
              s = __fadd_rn(static_cast<float>(ac[h]), static_cast<float>(ar[h]));
              s = __fmul_rn(__fmul_rn(s, __fmul_rn(sq_s[h], sk_s[t])), softmax_scale);
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
      const int lim = limit(h);
      const bool row_live = g * bn < lim;  // verify: any valid token of this row here
      const float m_prev = m_s[h], l_prev = l_s[h], sp_prev = sp_s[h];
      float mx = kAmla ? kNegInf : m_prev;
      for (int t = lane; t < bn; t += 32) mx = fmaxf(mx, ph[t]);
      mx = warp_max(mx);
      // FMA: the running max; AMLA: the max snapped up onto the log2 grid
      const float m_new = kAmla ? fmaxf(m_prev, ceilf(__fmul_rn(mx, kLog2e))) : mx;
      const float shift = kAmla ? __fmul_rn(m_new, kLn2) : m_new;
      float amax = 0.f, esum = 0.f;
      for (int t = lane; t < bn; t += 32) {
        const bool valid = g * bn + t < lim;
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
        if (kVerify && !row_live) e_new = sp_prev;  // row guard: rescale exactly 2^0
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
        if (kVerify && !row_live) sp_new = sp_prev;  // row guard: rescale exactly 1
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

    // 3. implicit dequantization: acc = acc * corr + P8 . C. Thread tid owns
    // the kCols columns from d0 = kCols*tid, read together per token; each
    // column sums its tokens in order.
    if (d0 < d_c) {
      float pv[W][kCols];
#pragma unroll
      for (int h = 0; h < W; ++h)
#pragma unroll
        for (int k = 0; k < kCols; ++k) pv[h][k] = 0.f;
      if (live) {
        const unsigned char* col = reinterpret_cast<const unsigned char*>(c_s) + d0 * sizeof(T);
        // the block's sink rows (tok < S_k), rounded up to 4, one token at
        // a time; the rest four at a time (the same order of sums)
        const int t_fast = kSink ? min(bn, max(0, S_k - g * bn + 3) / 4 * 4) : 0;
        for (int t = 0; kSink && t < t_fast; ++t) {
          const int tok = g * bn + t;
          float c[kCols];
          widen_cols<F, kCols>(col + t * c_row_bytes, c);
          if (tok < S_k) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) c[k] = sink_value(sink, b, S_k, tok, d0 + k, d_c, sk_s[t]);
          }
#pragma unroll
          for (int h = 0; h < W; ++h)
            if (h < nh)
#pragma unroll
              for (int k = 0; k < kCols; ++k) pv[h][k] = fmaf(p_s[h * bn + t], c[k], pv[h][k]);
        }
        for (int t = t_fast; t < bn; t += 4) {  // bn % 4 == 0: float4 reads of P
          const unsigned char* ct = col + t * c_row_bytes;
          float c0[kCols], c1[kCols], c2[kCols], c3[kCols];
          widen_cols<F, kCols>(ct, c0);
          widen_cols<F, kCols>(ct + c_row_bytes, c1);
          widen_cols<F, kCols>(ct + 2 * c_row_bytes, c2);
          widen_cols<F, kCols>(ct + 3 * c_row_bytes, c3);
#pragma unroll
          for (int h = 0; h < W; ++h) {
            if (h < nh) {
              const float4 p4 = *reinterpret_cast<const float4*>(p_s + h * bn + t);
#pragma unroll
              for (int k = 0; k < kCols; ++k) {
                pv[h][k] = fmaf(p4.x, c0[k], pv[h][k]);
                pv[h][k] = fmaf(p4.y, c1[k], pv[h][k]);
                pv[h][k] = fmaf(p4.z, c2[k], pv[h][k]);
                pv[h][k] = fmaf(p4.w, c3[k], pv[h][k]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < W; ++h) {
        if (h < nh) {
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            acc[h][k] = kAmla ? __fadd_rn(exp2_mul(acc[h][k], k_s[h]), pv[h][k])
                              : __fadd_rn(__fmul_rn(acc[h][k], corr_s[h]), pv[h][k]);
        }
      }
    }
    __syncthreads();  // closes block g: its stage may be refilled
  }

  // epilogue. FMA: (acc / l, m + log(sigma_p * l), sigma_p) — sigma_p cancels
  // in o. AMLA single pass: (acc / l, (i + e) ln2 + log l); AMLA split: the
  // raw (acc, l, g = i + e), merged by #4's arithmetic (amla_merge).
  const size_t out0 = (static_cast<size_t>(b) * S + split) * H + h0;
  constexpr bool raw = kAmla && !kSinglePass;
  // folded at one split: the tile's merge needs no other block's partial, so
  // the split writes o and lse straight into o_out, lse_out, whose layout
  // [B, H, .] is the partials' at S = 1. FMA: C's merge of one partial is
  // the identity (w = exp(0) = 1, den = 1, o * 1 / 1 = o, lse + log 1 = lse;
  // a partial is never -0 or NaN), so the partial itself. AMLA: #4's merge of
  // one partial is not the identity (amla_single), so the block runs it.
  const bool direct = !kSinglePass && o_out != nullptr && S == 1;
  float* o_dst = direct ? o_out : o_part;
  float* lse_dst = direct ? lse_out : lse_part;
  if (d0 < d_c) {
#pragma unroll
    for (int h = 0; h < W; ++h) {
      if (h < nh) {
        const float l = l_s[h];
        float o[kCols];
        if (raw && direct) {
          amla_single<kCols>(acc[h], l, __fadd_rn(m_s[h], sp_s[h]), o);
        } else {
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            o[k] = raw ? acc[h][k] : acc[h][k] / l;
            if (!kSinglePass && !kAmla && !(l > 0.f)) o[k] = 0.f;  // empty split: neutral partial
          }
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) o_dst[(out0 + h) * d_c + d0 + k] = o[k];
      }
    }
  }
  if (tid < nh) {
    const float l = l_s[tid];
    if constexpr (kAmla) {
      const float g = __fadd_rn(m_s[tid], sp_s[tid]);
      if (raw && direct) {
        const float none[1] = {0.f};
        float unused[1];
        lse_out[out0 + tid] = amla_single<1>(none, l, g, unused);
      } else if (raw) {
        lse_part[out0 + tid] = l;
        sp_part[out0 + tid] = l > 0.f ? g : 0.f;
      } else {
        lse_part[out0 + tid] = __fadd_rn(__fmul_rn(g, kLn2), logf(l));
      }
    } else {
      float lse = __fadd_rn(m_s[tid], logf(__fmul_rn(sp_s[tid], l)));
      if (!kSinglePass && !(l > 0.f)) lse = kNegInf;
      lse_dst[out0 + tid] = lse;
      if (sp_part != nullptr) sp_part[out0 + tid] = sp_s[tid];
    }
  }

  // C folded (FMA) or #4 folded (AMLA): the block that draws the tile's last
  // ticket merges its S partials into o_out [B, H, d_c] and lse_out [B, H]
  // (see the design note)
  if constexpr (!kSinglePass) {
    if (o_out != nullptr && S > 1) {
      // the block's partial is written (the barrier) and released with its
      // ticket
      __syncthreads();
      bool last = false;
      if (tid == 0) {
        int* ticket = tickets + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
        last = draw_ticket(ticket) == S - 1;
        if (last) atomicExch(ticket, 0);   // every split has drawn: reset for the next launch
      }
      if (__syncthreads_or(last)) {
        // items of 8, 4 or 1 latent columns, so the threads share the tile;
        // a narrow tile (W * kMaxDc < 4 * kThreads columns) compiles the
        // one-column merge only, which keeps the kernel's registers (the
        // merge's loads in flight) within what lets two blocks share an SM
        const size_t part0 = static_cast<size_t>(b) * S * H + h0;
        const int cols = nh * d_c;
        if constexpr (kAmla) {
          // the shift table: kWide (K*, den) pairs, then S shifts per head, in
          // the block's shared memory (free once the last block has been
          // closed; launch_decode sizes it)
          float2* kd = reinterpret_cast<float2*>(smem);
          if constexpr (W * kMaxDc >= 4 * kThreads) {
            if (d_c % 8 == 0 && cols >= 8 * kThreads && S <= 4)
              amla_merge_tile<8, 4>(o_part, lse_part, sp_part, o_out, lse_out, part0, row0, nh,
                                    H, S, d_c, kd);
            else if (cols >= 4 * kThreads)
              amla_merge_tile<4, 8>(o_part, lse_part, sp_part, o_out, lse_out, part0, row0, nh,
                                    H, S, d_c, kd);
            else
              amla_merge_tile<1, 4>(o_part, lse_part, sp_part, o_out, lse_out, part0, row0, nh,
                                    H, S, d_c, kd);
          } else {
            amla_merge_tile<1, 4>(o_part, lse_part, sp_part, o_out, lse_out, part0, row0, nh, H,
                                  S, d_c, kd);
          }
        } else if constexpr (W * kMaxDc >= 4 * kThreads) {
          if (d_c % 8 == 0 && cols >= 8 * kThreads && S <= 4)
            merge_tile<8, 4>(o_part, lse_part, o_out, lse_out, part0, row0, nh, H, S, d_c);
          else if (cols >= 4 * kThreads)
            merge_tile<4, 8>(o_part, lse_part, o_out, lse_out, part0, row0, nh, H, S, d_c);
          else
            merge_tile<1, 4>(o_part, lse_part, o_out, lse_out, part0, row0, nh, H, S, d_c);
        } else {
          merge_tile<1, 4>(o_part, lse_part, o_out, lse_out, part0, row0, nh, H, S, d_c);
        }
      }
    }
  }
}

template <int F, int W, bool kSinglePass, bool kAmla, bool kSink, bool kVerify>
static cudaError_t launch_decode(const void* q_c8, const float* q_r, const float* sigma_q,
                                 const float* q_lat, const float* q_rope, const void* content,
                                 const void* rope, const float* scale, const int* page_table,
                                 const int* seq_lens, const float* sink, int S_k, float* o_part,
                                 float* lse_part, float* sp_part, float* o, float* lse,
                                 int* tickets, int B, int H, int d_c, int d_r, int bn, int P,
                                 int num_splits, int blocks_per_split, float softmax_scale,
                                 int q_len, cudaStream_t stream) {
  using T = typename Format<F>::T;
  auto kern = decode_kernel<F, W, kSinglePass, kAmla, kSink, kVerify>;
  // registers per thread and SMs, read once (outside any graph capture)
  static int regs = 0, sms = 0;
  if (regs == 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  // the deepest ring that fits; when the grid has more blocks than SMs and
  // the registers allow two blocks per SM, the deepest ring that lets two
  // blocks share an SM (each block's loads then overlap the other's compute)
  const long long blocks = static_cast<long long>((H + W - 1) / W) * num_splits * B;
  const bool two = blocks > sms && 2 * kThreads * regs <= kRegsPerSm;
  const int limit = two ? kSmemPerSm / 2 - kSmemReserved : kSmemLimit;
  Layout L = layout<F, W>(d_c, d_r, bn, kMaxStages);
  for (int D = kMaxStages - 1; D >= 1 && L.total > limit; --D) L = layout<F, W>(d_c, d_r, bn, D);
  if (L.total > limit) L = layout<F, W>(d_c, d_r, bn, 1);
  if (kAmla && !kSinglePass && o != nullptr)   // #4 folded: its shift table
    L.total = max(L.total, static_cast<int>(sizeof(float2)) * kWide + 4 * W * num_splits);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  L.c_chunk = chunk_bytes(d_c * static_cast<int>(sizeof(T)), L.c_row_words * 4, content);
  L.r_chunk = chunk_bytes(d_r * 2, L.r_row_words * 4, rope);
  L.sk_chunk = chunk_bytes(bn * 4, bn * 4, scale);
  if (!L.c_chunk || !L.r_chunk || !L.sk_chunk) return cudaErrorInvalidValue;
  // raise the kernel's dynamic shared-memory limit once (grow-only), so a
  // later call inside CUDA-graph capture makes no attribute call
  static int smem_limit = 0;
  if (L.total > smem_limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    smem_limit = L.total;
  }
  const dim3 grid((H + W - 1) / W, num_splits, B);
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q_c8), q_r, sigma_q, q_lat, q_rope, static_cast<const T*>(content),
      static_cast<const __nv_bfloat16*>(rope), scale, page_table, seq_lens, sink, S_k, o_part,
      lse_part, sp_part, o, lse, tickets, H, d_c, d_r, bn, P, blocks_per_split, softmax_scale,
      q_len, L);
  return cudaGetLastError();
}

// C, standalone: lse_merge per latent column; one block per (head, batch
// row). The FMA split kernels run the same merge in their epilogue; this
// launch serves a caller that keeps the partials. Bound: it reads S*H*d_c*4
// partial bytes and writes H*d_c*4 per row.
__global__ void lse_combine_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ lse_part, float* __restrict__ o,
                                   float* __restrict__ lse, int S, int H, int d_c) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t part0 = static_cast<size_t>(b) * S * H + h;
  for (int d = threadIdx.x; d < d_c; d += blockDim.x) {
    float out[1];
    const float l = lse_merge<1, 4>(o_part + part0 * d_c + d, static_cast<size_t>(H) * d_c,
                                 lse_part + part0, static_cast<size_t>(H), S, out);
    o[(static_cast<size_t>(b) * H + h) * d_c + d] = out[0];
    if (d == 0) lse[static_cast<size_t>(b) * H + h] = l;
  }
}

// #4, standalone: the combine-free AMLA merge. Split s holds the raw
// (acc_s, l_s) of scale 2^g_s; shift every split with data onto K* = max g_s
// by exp2_mul (an integer exponent add), sum, then one division and one log:
// o = sum acc_s 2^(g_s - K*) / sum l_s 2^(g_s - K*), lse = K* ln2 + log(den).
// One block of kCombineThreads per (head, batch row): warp 0 computes the
// head's K*, den and shifts into shared memory (amla_head), then each thread
// merges N (4, or 1 where d_c % 4 != 0) latent columns with them
// (amla_merge), up to 8 splits' loads in flight (the parent walked the S
// partials one dependent load at a time). The AMLA split kernels run the
// same routines in their epilogue; this launch serves a caller that keeps the
// partials. Bound: like C, S*H*(d_c + 2)*4 bytes in.
constexpr int kCombineThreads = 128;

template <int N>
__global__ void __launch_bounds__(kCombineThreads)
amla_combine_kernel(const float* __restrict__ acc_part, const float* __restrict__ l_part,
                    const float* __restrict__ g_part, float* __restrict__ o,
                    float* __restrict__ lse, int S, int H, int d_c) {
  extern __shared__ float2 kd_s[];   // (K*, den), then the S shifts
  int* shifts = reinterpret_cast<int*>(kd_s + 1);
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t part0 = static_cast<size_t>(b) * S * H + h;
  if (threadIdx.x < 32) {
    const float2 r = amla_head(l_part + part0, g_part + part0, H, S, shifts);
    if (threadIdx.x == 0) kd_s[0] = r;
  }
  __syncthreads();
  const float2 r = kd_s[0];
  for (int c = threadIdx.x * N; c < d_c; c += kCombineThreads * N) {
    float out[N];
    amla_merge<N, 8>(acc_part + part0 * d_c + c, static_cast<size_t>(H) * d_c, shifts, S, r.y,
                     out);
    store_cols<N>(o + (static_cast<size_t>(b) * H + h) * d_c + c, out);
  }
  if (threadIdx.x == 0) lse[static_cast<size_t>(b) * H + h] = amla_lse(r.x, r.y);
}

}  // namespace snap

// One entry point for every decode kernel: fmt, single_pass and amla pick
// the template; page_table == nullptr selects contiguous block addressing
// (content [B, P*block, d_c]); sink (with S_k rows) is the contiguous
// cache's sink guard shadow or nullptr; q_len > 1 selects the verify mode
// (split mode, no sink; H is then the row count q_len * heads); width is the
// head tile (heads per block), kWide or kNarrow. The query is either
// prepared (q_c8, q_r, sigma_q) or raw (q_lat [B, H, d_c], q_rope [B, H, d_r]
// float32, fp8 / int8 only: D runs in the prologue), the other pointers of
// the query nullptr. o [B, H, d_c], lse [B, H] and tickets (B x head tiles
// int32 counters, zero before the launch and zero after it) fold C into the
// FMA split epilogue and #4 into the AMLA split epilogue (which then needs
// sp_part, the g partials); nullptr leaves the merge to the caller.
extern "C" int snapmla_decode(int fmt, int single_pass, int amla, const void* q_c8,
                              const void* q_r, const void* sigma_q, const void* q_lat,
                              const void* q_rope, const void* content, const void* rope,
                              const void* scale, const void* page_table, const void* seq_lens,
                              const void* sink, int S_k, void* o_part, void* lse_part,
                              void* sp_part, void* o, void* lse, void* tickets, int B, int H,
                              int d_c, int d_r, int block, int P, int num_splits,
                              int blocks_per_split, float softmax_scale, int q_len, int width,
                              void* stream) {
  using namespace snap;
  const bool raw = q_lat != nullptr;
  const bool fold = o != nullptr;
  if (d_c % 4 || d_r % 2 || block < kThreads / 32 || block > kThreads || kThreads % block ||
      d_c > kMaxDc || num_splits < 1 ||
      (single_pass && num_splits != 1) || S_k < 0 || (S_k > 0 && sink == nullptr) ||
      q_len < 1 || H % q_len || (q_len > 1 && (single_pass || S_k > 0)) ||
      (raw ? (q_rope == nullptr || fmt == kNone)
           : (q_c8 == nullptr || q_r == nullptr || sigma_q == nullptr)) ||
      (fold && (single_pass || lse == nullptr || tickets == nullptr ||
                (amla && (sp_part == nullptr || num_splits > kMaxAmlaFoldSplits)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ql = static_cast<const float*>(q_lat);
  const auto* qrope = static_cast<const float*>(q_rope);
  auto* out_o = static_cast<float*>(o);
  auto* out_lse = static_cast<float*>(lse);
  auto* tk = static_cast<int*>(tickets);
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
#define SNAP_LAUNCH_W(F, W, SP, AM, SK, VF)                                                      \
  launch_decode<F, W, SP, AM, SK, VF>(q_c8, qr, sq, ql, qrope, content, rope, sc, pt, sl, sk,    \
                                      S_k, op, lp, spp, out_o, out_lse, tk, B, H, d_c, d_r,      \
                                      block, P, num_splits, blocks_per_split, softmax_scale,     \
                                      q_len, st)
#define SNAP_LAUNCH(F, SP, AM, SK, VF)                 \
  (width == kWide     ? SNAP_LAUNCH_W(F, kWide, SP, AM, SK, VF)   \
   : width == kNarrow ? SNAP_LAUNCH_W(F, kNarrow, SP, AM, SK, VF) \
                      : cudaErrorInvalidValue)
#define SNAP_DECODE(F, SP, AM)                                                              \
  (S_k > 0 ? SNAP_LAUNCH(F, SP, AM, true, false) : SNAP_LAUNCH(F, SP, AM, false, false))
#ifdef SNAPMLA_NO_VERIFY
#define SNAP_VERIFY(F) cudaErrorInvalidValue
#else
#define SNAP_VERIFY(F) \
  (amla ? SNAP_LAUNCH(F, false, true, false, true) : SNAP_LAUNCH(F, false, false, false, true))
#endif
#define SNAP_MODES(F)                                                                   \
  (q_len > 1 ? SNAP_VERIFY(F)                                                           \
   : amla    ? (single_pass ? SNAP_DECODE(F, true, true) : SNAP_DECODE(F, false, true)) \
             : (single_pass ? SNAP_DECODE(F, true, false) : SNAP_DECODE(F, false, false)))
  cudaError_t err;
  switch (fmt) {
    case kFp8: err = SNAP_MODES(kFp8); break;
    case kInt8: err = SNAP_MODES(kInt8); break;
    case kNone: err = SNAP_MODES(kNone); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SNAP_MODES
#undef SNAP_VERIFY
#undef SNAP_DECODE
#undef SNAP_LAUNCH
#undef SNAP_LAUNCH_W
  return static_cast<int>(err);
}

extern "C" int snapmla_lse_combine(const void* o_part, const void* lse_part, void* o, void* lse,
                                   int B, int S, int H, int d_c, void* stream) {
  using namespace snap;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  lse_combine_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
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
  const auto* ap = static_cast<const float*>(acc_part);
  const auto* lp = static_cast<const float*>(l_part);
  const auto* gp = static_cast<const float*>(g_part);
  auto* out_o = static_cast<float*>(o);
  auto* out_lse = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  // four columns per thread where every row of acc and o is 16-byte aligned
  const bool wide = d_c % 4 == 0 && reinterpret_cast<uintptr_t>(ap) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out_o) % 16 == 0;
  const size_t smem = sizeof(float2) + 4 * static_cast<size_t>(S);
  if (wide)
    amla_combine_kernel<4><<<grid, kCombineThreads, smem, st>>>(ap, lp, gp, out_o, out_lse, S, H,
                                                                d_c);
  else
    amla_combine_kernel<1><<<grid, kCombineThreads, smem, st>>>(ap, lp, gp, out_o, out_lse, S, H,
                                                                d_c);
  return static_cast<int>(cudaGetLastError());
}
