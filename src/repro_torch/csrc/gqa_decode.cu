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
// Bound on the H100: bytes — the valid slots' K, V and scales, slot_pos for
// all N slots, q and o, at 3.35 TB/s (1.3 us at llama3.2-3b's serving shape,
// 34 us at 32k tokens per row). What a KV block costs instead is latency:
// sigma_p's chain needs the blocks in order (the sequential grid axis of the
// TPU kernel becomes a loop over blocks inside one CUDA block), so each CUDA
// block runs one dependent chain of QK, softmax and PV per KV block, and only
// the number of CUDA blocks fills the card.
//
// Design. One CUDA block per (head tile of W query heads, kv head, batch
// row): grid (Hkv * ceil(g / W), B); 256 threads, or 512 at W = 1 where a
// KV block holds at least 16,384 fp8 / int8 values (more warps to hide the
// latency of the one-row chain). The wrapper picks W per
// launch so that the grid covers the SMs where it can
// (kernels/gqa_decode/kernel.py::gqa_head_width). The width only decides
// which CUDA block computes a query row: every sum below runs per row in the
// same order at every width, so all widths give the same bits. Per block:
//   0. a ring of D shared-memory stages, each holding one KV block's K rows,
//      V rows (dh elements at a stride of Hkv*dh in the cache), ks and vs,
//      filled by cp.async (16 bytes per row copy, 4 per scale), one commit
//      group per block, D - 1 blocks in flight while one computes. slot_pos
//      is read one block further ahead (plain loads, consumed after the
//      block's compute), so a slot's validity is known before its copies are
//      issued: invalid slots and slots past N are zero-filled (src-size 0)
//      and read nothing (e4m3 0x7F is NaN, and 0 * NaN would poison acc); a
//      block with no valid slot issues no copy and skips the dots and all but
//      one barrier: every thread runs the all-masked block's sigma_p update
//      in registers. D is the deepest ring that fits (at most
//      kGqaMaxStages), within half an SM when the grid exceeds the SMs and
//      two blocks fit an SM by registers; where not even one stage fits (bf16
//      at block 512 and dh 128) the stage holds V only and the QK reads K
//      from global memory;
//   1. QK: a group of dh*sizeof(T)/16 lanes per slot, one 16-byte chunk of
//      the slot's K row each, dotted with the tile's W query rows, which each
//      thread keeps in registers (its chunk of every row, in float64) for the
//      whole walk; each chunk is summed in order from 0 with fma, then the
//      group adds its partial sums by the __shfl_xor tree from chunks/2 down
//      (W = 1: two slots per thread at once, independent chains);
//   2. one warp per query row: the online max, e, p~, sigma_p, P8, corr, l
//      (the sum of e lane-strided in float64, then the xor tree from 16);
//   3. PV. fp8 and int8: every product P8 * V is exact in float64 and a
//      block's sum of them is a multiple of 2^-18 below 2^45 (int8: an
//      integer), exact in any order, so each column's bn-slot sum is split:
//      a thread takes a 32-bit word of four columns and every
//      (threads / (dh/4))-th slot (two accumulators at W = 1), the partial
//      sums are reduced by shuffles inside a warp and over the warps in
//      shared memory (at dh 256 a row has 64 words: a warp holds 32 of
//      them, and the warps holding the same 32 are summed); none (bf16 V,
//      unquantized P): one thread per (row, column) sums the slots in order
//      from 0; acc = acc * corr + f32(pv), the accumulator in registers.
// The QK and PV dots and the sum of e accumulate in float64 and round once,
// as the plain version (kernels/gqa_decode/ref.py) does. Every float32
// product and sum whose rounding the plain version fixes is written with
// __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract it into an FMA.
//
// Head sizes: dh 16, 32, 64 and 128 run the instantiations of MaxDh 128,
// dh 256 (recurrentgemma-9b's MQA) those of MaxDh 256, so the smaller heads
// keep their registers: only the outputs per thread (acc) and the PV
// reduction's last step depend on it. At dh 256 a stage of fp8 K and V is
// 64 KB and of bf16 128 KB: the launch cuts the ring to the deepest that
// fits, as for any block that does not fit a deeper one.
//
// Left for later: the softmax runs on one warp per row while the others wait
// (about a fifth of a block at 32k): overlapping it with the previous block's
// PV (warp specialisation) would hide it; the float64 dots run on the CUDA
// cores (the f64 tensor cores, mma.m8n8k4.f64, would keep the fp8 / int8 PV
// exact); a walk split over the sequence changes the function (an LSE merge
// of per-split sigma_p chains).
#include "common.cuh"

namespace snap {

// threads per block: 256, or at width 1 up to 512 (more warps to hide the
// latency of a one-row chain where a KV block is large); wider tiles keep
// their query rows in registers and stay at 256
constexpr int kGqaThreads = 256;
template <int W> constexpr int kGqaMaxThreads = W == 1 ? 512 : kGqaThreads;
constexpr int kGqaMaxStages = 4;           // shared-memory stages of the K/V ring
static_assert(kGqaMaxStages <= 4, "cp_async_wait waits for at most 3 pending groups");
constexpr int kGqaSmemLimit = 227 * 1024;  // dynamic shared memory of one block
constexpr int kGqaSmemPerSm = 228 * 1024;  // of one SM, for all its blocks
constexpr int kGqaSmemReserved = 1024;     // the system's share of each block
constexpr int kGqaRegsPerSm = 65536;
// the largest head of each instantiation bucket (dh <= 128, dh = 256)
constexpr int kGqaMaxDhSmall = 128;
constexpr int kGqaMaxDhLarge = 256;
// head-tile widths (query heads per block); the wrapper's GQA_HEAD_WIDTHS
// (kernels/gqa_decode/kernel.py) lists the same two
constexpr int kGqaWide = 4;
constexpr int kGqaNarrow = 1;

// byte offsets into the dynamic shared memory of one block; k, v, ks and vs
// are offsets inside a stage (k < 0: K is not staged), the ring's stage i
// starting at stage + i*stage_bytes
struct GqaLayout {
  int s, red, state, valid, stage, stage_bytes, stages, total;
  int k, v, ks, vs;
};

namespace {

int gqa_take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

template <int F, int W>
GqaLayout gqa_layout(int threads, int dh, int bn, int stages, bool stage_k) {
  GqaLayout L;
  const int rows = bn * dh * static_cast<int>(sizeof(typename Format<F>::T));
  int off = 0;
  L.s = gqa_take(off, W * bn * 4);
  // each warp's PV partials: 4 columns of at most 32 words per query row
  L.red = gqa_take(off, F == kNone ? 0 : threads / 32 * W * 4 * (dh / 4 < 32 ? dh / 4 : 32) * 8);
  L.state = gqa_take(off, 4 * W * 4);
  L.valid = gqa_take(off, (stages + 1) * bn * 4);
  int s = 0;
  L.k = stage_k ? gqa_take(s, rows) : -1;
  L.v = gqa_take(s, rows);
  L.ks = gqa_take(s, bn * 4);
  L.vs = gqa_take(s, bn * 4);
  L.stage_bytes = s;
  L.stages = stages;
  L.stage = gqa_take(off, stages * s);
  L.total = off;
  return L;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[j] for a runtime j < W, kept in registers
template <int W>
__device__ __forceinline__ float pick(const float (&a)[W], int j) {
  float r = a[0];
#pragma unroll
  for (int x = 1; x < W; ++x)
    if (x == j) r = a[x];
  return r;
}

__device__ __forceinline__ uint32_t word_of(const uint4& c, int i) {
  return i == 0 ? c.x : (i == 1 ? c.y : (i == 2 ? c.z : c.w));
}

}  // namespace

template <int F, int W, int MaxDh>
__global__ void __launch_bounds__(kGqaMaxThreads<W>)
gqa_decode_kernel(const float* __restrict__ q, const typename Format<F>::T* __restrict__ k,
                  const typename Format<F>::T* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                  const int* __restrict__ positions, float* __restrict__ o, int N, int Hkv,
                  int g, int dh, int bn, int window, float sm_scale, GqaLayout L) {
  using Fm = Format<F>;
  using T = typename Fm::T;
  using U = Unpack<F>;
  constexpr int kChunkVals = 4 * U::kPerWord;  // values in a 16-byte chunk
  constexpr int kRounds = W == 1 ? 2 : 1;     // slots per thread per QK round
  constexpr int kPvSets = W == 1 ? 2 : 1;     // independent PV accumulators
  constexpr int kOut = (W * MaxDh + kGqaThreads - 1) / kGqaThreads;  // outputs per thread
  constexpr bool kWideRow = MaxDh > 128;  // a V row of more than 32 words
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem + L.s);        // [W][bn] logits, then P8
  double* red_s = reinterpret_cast<double*>(smem + L.red);  // [warps][W][4][slab] PV partials
  float* st_s = reinterpret_cast<float*>(smem + L.state);   // m, l, sigma_p, corr [4][W]
  int* valid_s = reinterpret_cast<int*>(smem + L.valid);    // [D + 1][bn] slot validity
  unsigned char* ring = smem + L.stage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt / 32;  // threads, warps
  const int tiles = (g + W - 1) / W;
  const int h = blockIdx.x / tiles, j0 = (blockIdx.x - h * tiles) * W;
  const int nj = min(W, g - j0);  // query rows of this tile
  const int b = blockIdx.y;
  const int H = Hkv * g;
  const int pos = positions[b];
  const size_t q0 = (static_cast<size_t>(b) * H + static_cast<size_t>(h) * g + j0) * dh;
  const int esize = static_cast<int>(sizeof(T));
  const int row_bytes = dh * esize;
  const int chunks = row_bytes / 16;  // 16-byte chunks of a row (a power of two)
  const int lc = __ffs(chunks) - 1;   // log2(chunks)
  const int per_pass = nt / chunks;   // slots per QK pass
  const size_t row_stride = static_cast<size_t>(Hkv) * dh;  // elements between slots
  const int nb = (N + bn - 1) / bn;
  const int D = L.stages, R = D + 1;  // K/V stages; rows of the validity ring

  // this thread's chunk of every query row of the tile (loaded first, so the
  // loads overlap the prologue's)
  const int c = tid & (chunks - 1);
  float qf[W][kChunkVals];
#pragma unroll
  for (int j = 0; j < W; ++j)
#pragma unroll
    for (int e = 0; e < kChunkVals; ++e)
      qf[j][e] = j < nj ? q[q0 + j * dh + c * kChunkVals + e] : 0.f;
  // slot_pos of block blk for this thread's slots tid and tid + nt (-1 past N)
  auto load_sp = [&](int blk, int (&r)[2]) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = tid + x * nt, n = blk * bn + t;
      r[x] = blk < nb && t < bn && n < N ? slot_pos[static_cast<size_t>(b) * N + n] : -1;
    }
  };
  // their validity into the ring; returns whether any is valid
  auto put_valid = [&](int blk, const int (&r)[2]) {
    int any = 0;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = tid + x * nt;
      if (t < bn) {
        const int ok = r[x] >= 0 && r[x] <= pos && (window == 0 || r[x] > pos - window);
        valid_s[(blk % R) * bn + t] = ok;
        any |= ok;
      }
    }
    return any;
  };
  unsigned live_bits = 0;  // bit blk % R: block blk has a valid slot
  // issue the copies of block blk (none when past the end or dead) into its
  // stage, blk mod D, as one commit group
  auto issue = [&](int blk) {
    if (blk < nb && ((live_bits >> (blk % R)) & 1u)) {
      unsigned char* st = ring + (blk % D) * L.stage_bytes;
      const int* vf = valid_s + (blk % R) * bn;
      const size_t slot0 = static_cast<size_t>(b) * N + static_cast<size_t>(blk) * bn;
      const size_t head = static_cast<size_t>(h) * dh;
      const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
      const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
      for (int i = tid; i < bn * chunks; i += nt) {
        const int t = i >> lc, cc = i & (chunks - 1);
        const bool ok = vf[t] != 0;
        const size_t off = ok ? ((slot0 + t) * row_stride + head) * esize + cc * 16 : 0;
        if (L.k >= 0) cp_async_zfill<16>(st + L.k + i * 16, kb + off, ok);
        cp_async_zfill<16>(st + L.v + i * 16, vb + off, ok);
      }
      for (int t = tid; t < bn; t += nt) {
        const bool ok = vf[t] != 0;
        const size_t si = ok ? (slot0 + t) * Hkv + h : 0;
        cp_async_zfill<4>(st + L.ks + t * 4, k_scale + si, ok);
        cp_async_zfill<4>(st + L.vs + t * 4, v_scale + si, ok);
      }
    }
    cp_async_commit();
  };

  // prologue: the validity of blocks 0 .. D-1, the copies of blocks 0 .. D-2
  {
    int r[kGqaMaxStages][2];
#pragma unroll
    for (int x = 0; x < kGqaMaxStages; ++x)
      if (x < D) load_sp(x, r[x]);
#pragma unroll
    for (int x = 0; x < kGqaMaxStages; ++x)
      if (x < D && __syncthreads_or(put_valid(x, r[x]))) live_bits |= 1u << x;
  }
  for (int x = 0; x < D - 1; ++x) issue(x);
  // the query chunks in float64, in registers for the whole walk
  double qr[W][kChunkVals];
#pragma unroll
  for (int j = 0; j < W; ++j)
#pragma unroll
    for (int e = 0; e < kChunkVals; ++e) qr[j][e] = qf[j][e];

  float m[W], l[W], sp[W], corr[W], acc[kOut];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    sp[j] = 1.f;
    corr[j] = 1.f;
  }
#pragma unroll
  for (int x = 0; x < kOut; ++x) acc[x] = 0.f;

  int sp_next[2];
  for (int blk = 0; blk < nb; ++blk) {
    issue(blk + D - 1);      // into the stage block blk - 1 read (closed by the last barrier)
    load_sp(blk + D, sp_next);  // used after this block's compute
    const bool live = (live_bits >> (blk % R)) & 1u;
    live_bits &= ~(1u << (blk % R));
    if (live) {
      cp_async_wait(D - 1);  // this thread's copies of block blk have landed ...
      __syncthreads();  // ... and every thread's
      const unsigned char* st = ring + (blk % D) * L.stage_bytes;
      const int* vf = valid_s + (blk % R) * bn;
      const float* ks_s = reinterpret_cast<const float*>(st + L.ks);
      const float* vs_s = reinterpret_cast<const float*>(st + L.vs);

      // 1. s = (q . k) * ks * sm_scale on valid slots, -1e30 elsewhere
      {
        const unsigned char* kbase;
        size_t kstride;
        if (L.k >= 0) {
          kbase = st + L.k;
          kstride = row_bytes;
        } else {
          kbase = reinterpret_cast<const unsigned char*>(
              k + (static_cast<size_t>(b) * N + static_cast<size_t>(blk) * bn) * row_stride +
              static_cast<size_t>(h) * dh);
          kstride = row_stride * esize;
        }
        for (int base = 0; base < bn; base += per_pass * kRounds) {
          int t[kRounds];
          bool in[kRounds];
          uint4 kw[kRounds];
          double a[kRounds][W];
#pragma unroll
          for (int x = 0; x < kRounds; ++x) {
            t[x] = base + x * per_pass + (tid >> lc);
            in[x] = t[x] < bn && vf[t[x]] != 0;
            kw[x] = in[x] ? *reinterpret_cast<const uint4*>(kbase + t[x] * kstride + c * 16)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int j = 0; j < W; ++j) a[x][j] = 0.0;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int x = 0; x < kRounds; ++x) {
              double kv[U::kPerWord];
              U::run(word_of(kw[x], i), kv);
#pragma unroll
              for (int e = 0; e < U::kPerWord; ++e)
#pragma unroll
                for (int j = 0; j < W; ++j)
                  a[x][j] = fma(qr[j][i * U::kPerWord + e], kv[e], a[x][j]);
            }
          }
          for (int off = chunks / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int x = 0; x < kRounds; ++x)
#pragma unroll
              for (int j = 0; j < W; ++j) a[x][j] += __shfl_xor_sync(0xffffffffu, a[x][j], off);
          }
          if (c == 0) {
#pragma unroll
            for (int x = 0; x < kRounds; ++x) {
              if (t[x] < bn) {
#pragma unroll
                for (int j = 0; j < W; ++j)
                  if (j < nj)
                    s_s[j * bn + t[x]] =
                        in[x] ? __fmul_rn(__fmul_rn(static_cast<float>(a[x][j]), ks_s[t[x]]),
                                          sm_scale)
                              : kNegInf;
              }
            }
          }
        }
      }
      __syncthreads();

      // 2. online softmax + scale fusion + block-wise dynamic P quantization,
      // one warp per query row
      if (warp < nj) {
        const int j = warp;
        float* sj = s_s + j * bn;
        const float m_prev = pick(m, j), l_prev = pick(l, j), sp_prev = pick(sp, j);
        float mx = m_prev;
#pragma unroll 4
        for (int t = lane; t < bn; t += 32) mx = fmaxf(mx, sj[t]);
        mx = warp_max(mx);
        float amax = 0.f;
        double esum = 0.0;
#pragma unroll 4
        for (int t = lane; t < bn; t += 32) {
          const bool ok = vf[t] != 0;
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
#pragma unroll 4
          for (int t = lane; t < bn; t += 32) sj[t] = Fm::widen(Fm::cast(sj[t] / sp_new));
        }
        if (lane == 0) {
          const float cr = __fmul_rn(expf(__fsub_rn(m_prev, mx)), sp_prev / sp_new);
          st_s[j] = mx;
          st_s[W + j] = __fadd_rn(__fmul_rn(l_prev, cr), static_cast<float>(esum) / sp_new);
          st_s[2 * W + j] = sp_new;
          st_s[3 * W + j] = cr;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < nj) {
          m[j] = st_s[j];
          l[j] = st_s[W + j];
          sp[j] = st_s[2 * W + j];
          corr[j] = st_s[3 * W + j];
        }
      }

      // 3. implicit dequantization: acc = acc * corr + P8 . V
      if constexpr (F != kNone) {
        // each column's sum split over slot groups (exact in any order)
        // (invalid slots add exact zeros: P8 is 0 there and V zero-filled)
        const int cw = dh / 4;  // 32-bit words of a V row
        const int cg = tid % cw, S = nt / cw;
        // the words of a row one warp holds: all of them, or 32 (wide rows)
        const int slab = kWideRow ? 32 : cw;
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(st + L.v);
        double pv[kPvSets][W][4];
#pragma unroll
        for (int a = 0; a < kPvSets; ++a)
#pragma unroll
          for (int j = 0; j < W; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) pv[a][j][x] = 0.0;
#pragma unroll 2
        for (int t0 = tid / cw; t0 < bn; t0 += S * kPvSets) {
#pragma unroll
          for (int a = 0; a < kPvSets; ++a) {
            const int t = t0 + a * S;
            if (t < bn) {
              double vv[4];
              U::run(vw[t * cw + cg], vv);
#pragma unroll
              for (int j = 0; j < W; ++j) {
                if (j < nj) {
                  const double p = s_s[j * bn + t];
#pragma unroll
                  for (int x = 0; x < 4; ++x) pv[a][j][x] = fma(p, vv[x], pv[a][j][x]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int a = 1; a < kPvSets; ++a)
#pragma unroll
          for (int j = 0; j < W; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) pv[0][j][x] += pv[a][j][x];
        for (int off = cw; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < W; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              pv[0][j][x] += __shfl_xor_sync(0xffffffffu, pv[0][j][x], off);
        }
        if (lane < cw) {
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (j < nj)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                red_s[((warp * W + j) * 4 + x) * slab + (kWideRow ? lane : cg)] = pv[0][j][x];
        }
        __syncthreads();
#pragma unroll
        for (int y = 0; y < kOut; ++y) {
          const int i = tid + y * nt;
          if (i < nj * dh) {
            const int j = i / dh, d = i - j * dh;
            double sum = 0.0;
            if constexpr (kWideRow) {
              // warps w and w + sets hold the same 32 words; word d >> 2 is
              // in the warps w % sets == (d >> 2) / 32 (4 or 8 of them)
              const int sets = cw / 32, word = d >> 2;
              const int at = (j * 4 + (d & 3)) * 32 + (word & 31);
              for (int w0 = word >> 5; w0 < nw; w0 += 4 * sets) {  // four loads in flight
                double part[4];
#pragma unroll
                for (int x = 0; x < 4; ++x) part[x] = red_s[(w0 + x * sets) * W * 4 * 32 + at];
#pragma unroll
                for (int x = 0; x < 4; ++x) sum += part[x];
              }
            } else {
              const int at = (j * 4 + (d & 3)) * cw + (d >> 2);
              for (int w0 = 0; w0 < nw; w0 += 8) {  // nw is 8 or 16: eight loads in flight
                double part[8];
#pragma unroll
                for (int x = 0; x < 8; ++x) part[x] = red_s[(w0 + x) * W * dh + at];
#pragma unroll
                for (int x = 0; x < 8; ++x) sum += part[x];
              }
            }
            acc[y] = __fadd_rn(__fmul_rn(acc[y], pick(corr, j)), static_cast<float>(sum));
          }
        }
      } else {
        // one thread per (row, column), the slots in order from 0
        const T* v_s = reinterpret_cast<const T*>(st + L.v);
#pragma unroll
        for (int y = 0; y < kOut; ++y) {
          const int i = tid + y * nt;
          if (i < nj * dh) {
            const int j = i / dh, d = i - j * dh;
            const float* pj = s_s + j * bn;
            double pv = 0.0;
#pragma unroll 8
            for (int t = 0; t < bn; ++t)
              pv = fma(static_cast<double>(pj[t]), static_cast<double>(Fm::widen(v_s[t * dh + d])),
                       pv);
            acc[y] = __fadd_rn(__fmul_rn(acc[y], pick(corr, j)), static_cast<float>(pv));
          }
        }
      }
    } else {
      // a block with no valid slot: P is all zero, the max stays, sigma_p
      // floors at EPS / qmax — the all-masked block's update, in registers
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < nj) {
          const float mx = fmaxf(m[j], kNegInf);
          float sp_new = 1.f;
          if constexpr (F != kNone) sp_new = dynamic_scale<F>(0.f);
          corr[j] = __fmul_rn(expf(__fsub_rn(m[j], mx)), sp[j] / sp_new);
          l[j] = __fadd_rn(__fmul_rn(l[j], corr[j]), static_cast<float>(0.0) / sp_new);
          m[j] = mx;
          sp[j] = sp_new;
        }
      }
#pragma unroll
      for (int y = 0; y < kOut; ++y) {
        const int i = tid + y * nt;
        if (i < nj * dh)
          acc[y] = __fadd_rn(__fmul_rn(acc[y], pick(corr, i / dh)), static_cast<float>(0.0));
      }
    }
    // closes block blk (its stage may be refilled) and publishes the
    // validity of block blk + D
    if (__syncthreads_or(put_valid(blk + D, sp_next))) live_bits |= 1u << ((blk + D) % R);
  }
  cp_async_wait(0);  // no copy outlives the block

#pragma unroll
  for (int y = 0; y < kOut; ++y) {
    const int i = tid + y * nt;
    if (i < nj * dh) o[q0 + i] = acc[y] / pick(l, i / dh);
  }
}

template <int F, int W, int MaxDh>
static cudaError_t launch_gqa(const float* q, const void* k, const void* v, const float* ks,
                              const float* vs, const int* slot_pos, const int* positions, float* o,
                              int B, int N, int Hkv, int g, int dh, int bn, int window,
                              float sm_scale, cudaStream_t stream) {
  using T = typename Format<F>::T;
  auto kern = gqa_decode_kernel<F, W, MaxDh>;
  // once per instantiation, before any CUDA-graph capture: the registers per
  // thread, the SM count, and the shared-memory limit raised to the most a
  // block may take (so no later call makes an attribute call)
  static int regs = 0, sms = 0;
  static const cudaError_t init = [&] {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGqaSmemLimit);
    return err;
  }();
  if (init != cudaSuccess) return init;
  // 512 threads at width 1 where a KV block's fp8 / int8 dots are large
  // (bn * dh >= 16384 values; measured faster there, slower on smaller
  // blocks and in bf16, whose PV is one thread per column)
  const int threads = W == 1 && F != kNone && bn * dh >= 16384 ? kGqaMaxThreads<W> : kGqaThreads;
  // the deepest ring that fits (no deeper than the walk); when the grid has
  // more blocks than SMs and the registers allow two blocks per SM, the
  // deepest that lets two share an SM (it binds only in bf16 at width 1,
  // where it measured 1.4-1.8x faster at 192-384 blocks than one block with
  // a deeper ring); where no staged ring fits, V alone staged and K read
  // from global memory
  const int tiles = (g + W - 1) / W;
  const long long blocks = static_cast<long long>(Hkv) * tiles * B;
  const bool two = blocks > sms && 2 * threads * regs <= kGqaRegsPerSm;
  const int limit = two ? kGqaSmemPerSm / 2 - kGqaSmemReserved : kGqaSmemLimit;
  const int nb = (N + bn - 1) / bn;
  const int deepest = nb < kGqaMaxStages ? nb : kGqaMaxStages;
  GqaLayout L = gqa_layout<F, W>(threads, dh, bn, deepest, true);
  for (int D = deepest - 1; D >= 1 && L.total > limit; --D)
    L = gqa_layout<F, W>(threads, dh, bn, D, true);
  if (L.total > limit) L = gqa_layout<F, W>(threads, dh, bn, 1, true);
  if (L.total > kGqaSmemLimit) L = gqa_layout<F, W>(threads, dh, bn, 1, false);
  if (L.total > kGqaSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(Hkv * tiles, B);
  kern<<<grid, threads, L.total, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, slot_pos, positions, o, N,
      Hkv, g, dh, bn, window, sm_scale, L);
  return cudaGetLastError();
}

}  // namespace snap

// q [B, H, dh] f32, k / v [B, N, Hkv, dh] (fp8 / int8 / bf16 by fmt, 16-byte
// aligned), k_scale / v_scale [B, N, Hkv] f32, slot_pos [B, N] int32,
// positions [B] int32 -> o [B, H, dh] f32, H = Hkv * g. dh in {16, 32, 64,
// 128, 256}; block a power of two in [16, 512]; N need not be a multiple of it;
// width is the head tile (query heads per CUDA block), kGqaWide or
// kGqaNarrow.
extern "C" int snapmla_gqa_decode(int fmt, const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* slot_pos,
                                  const void* positions, void* o, int B, int N, int Hkv, int g,
                                  int dh, int block, int window, float sm_scale, int width,
                                  void* stream) {
  using namespace snap;
  const bool dh_ok = dh == 16 || dh == 32 || dh == 64 || dh == 128 || dh == 256;
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
#define SNAP_GQA_DH(F, W, M) \
  launch_gqa<F, W, M>(qf, k, v, ks, vs, sp, ps, out, B, N, Hkv, g, dh, block, window, sm_scale, st)
#define SNAP_GQA_W(F, W)                                       \
  (dh <= kGqaMaxDhSmall ? SNAP_GQA_DH(F, W, kGqaMaxDhSmall) \
                        : SNAP_GQA_DH(F, W, kGqaMaxDhLarge))
#define SNAP_GQA(F)                          \
  (width == kGqaWide     ? SNAP_GQA_W(F, kGqaWide)   \
   : width == kGqaNarrow ? SNAP_GQA_W(F, kGqaNarrow) \
                         : cudaErrorInvalidValue)
  cudaError_t err;
  switch (fmt) {
    case kFp8: err = SNAP_GQA(kFp8); break;
    case kInt8: err = SNAP_GQA(kInt8); break;
    case kNone: err = SNAP_GQA(kNone); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SNAP_GQA
#undef SNAP_GQA_W
#undef SNAP_GQA_DH
  return static_cast<int>(err);
}
