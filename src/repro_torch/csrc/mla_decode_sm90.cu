// SnapMLA FP8 decode on the H100's tensor cores: kernel A's route for an
// fp8_e4m3 pool, the FMA rescale, one query token (q_len = 1), d_c = 512,
// d_r = 64, pages of 64 or 128 tokens and C folded (no partials returned).
//
// Replaces (the reference JAX package, Pallas on TPU):
//   repro/kernels/mla_decode/kernel.py: mla_decode_paged_splitkv_pallas
//   (_paged_splitkv_body -> _mla_decode_splitkv_kernel -> _block_pipeline at
//   q_len = 1, rescale "fma", fp8), with Fused-Q-Quant (D) in its prologue and
//   the LSE combine (C) in its epilogue, as kernel A of csrc/mla_decode.cu
//   does. Every other decode call keeps that kernel, which stays the bit-exact
//   implementation of the pipeline (AMLA, the verify mode, int8 / none, the
//   sink guard, contiguous caches, single pass, returned partials);
//   kernels/mla_decode/kernel.py::decode_design is the routing rule.
//
// Bound on the H100: 644 bytes a live token (512 fp8 content + 128 bf16 rope
// + 4 scale) at 3.35 TB/s against (2*576 + 2*512) FLOP a token and head at
// the fp8 tensor cores' 1,979 TFLOP/s. At 128 heads that is 432 FLOP a byte,
// at 32 heads 108, both below the card's 591: the kernel is bound by the
// bytes it reads, which it reads once per 64-head group (below).
//
// Design. One CTA of 256 threads (two warpgroups) per (64-head group, split,
// batch row); the grid's x is the head group, so a (row, split)'s groups run
// side by side and the second read of each page hits L2. Thread 0 is the
// producer: it reads the page table and keeps a ring of kStages stages in
// flight by TMA (the page's content as four [page, 128 B] boxes and its rope
// as one [page, 64] box, both 128-byte swizzled, its scales by one bulk
// copy), each stage guarded by an mbarrier; a stage is refilled at the first
// barrier of the page after the one that read it. A separate producer warp
// would cost registers: an SM sub-partition holds 16,384, so at 9 warps a
// CTA (three on one sub-partition) a thread gets 168 and the accumulators
// spill; at 8 it gets 255. Both warpgroups consume every page:
//   0. the prologue, while the first pages load: the group's 64 query rows
//      (rows past H zero) into shared memory as the wgmma A operands — the
//      fp8 content query, 128-byte swizzled; a raw query is quantized here
//      with D's operations (q_quant.cu): sigma_q = max(max|q_lat|, EPS) /
//      qmax, q = cast(q_lat / sigma_q), q_r = q_rope / sigma_q, each an IEEE
//      division. The float32 q_r is split into three bf16 terms, hi + mid +
//      lo, which hold it exactly; each term's product with a bf16 rope value
//      is exact in float32;
//   1. QK: S[64 heads, page] = q.C + q_r.R, each warpgroup half the page's
//      tokens: fp8 wgmma m64 x n(page / 2) x k32 over the 512 content columns,
//      each of the 16 steps a fresh accumulator added to S in float32 on the
//      CUDA cores (the fp8 tensor core keeps fewer bits than float32 inside a
//      sum; promoting every 128 products instead moved the outputs twice as
//      far from the plain version's at the cells' shapes, and the cells' gate
//      readings came within a factor of two of their limits; PV promotes as
//      often, below), then the three bf16 rope passes (k16, 64 columns each)
//      into one fresh accumulator.
//      s = (S_c + S_r) * (sigma_q * sigma_k) * scale, masked to tok < seq_len;
//   2. the online softmax of kernel A, per head over exactly one page: the
//      warpgroups exchange the row max and then (max|p~|, sum e) through
//      shared memory; m_new, e = exp(s - m_new), p~ = e * sigma_k, sigma_p =
//      max(max|p~|, EPS) / qmax, P8 = fp8(p~ / sigma_p), corr = exp(m_prev -
//      m_new) * sigma_p_prev / sigma_p, l = l * corr + sum e / sigma_p. P8 is
//      written into the page's rope stage, which QK no longer reads, its
//      tokens in the order PV's register operand reads them (step 3);
//   3. PV: O^T[512, 64] = C^T . P8^T. The content tile is MN-major for PV and
//      fp8 wgmma takes only K-major shared operands, so C^T is the register
//      operand A, gathered from the swizzled tile a byte at a time (a 32-bit
//      register holds four tokens of one column; 256 byte loads a thread and
//      page, each warp's load in 8 banks: k slot 4x + y of a 16-slot half
//      holds token x + 4y), the next tile's bytes while a tile's wgmmas run,
//      and P8^T, rows per head, the shared operand B. Each warpgroup holds 256
//      output columns (four m64 x n64 tiles, 128 float32 registers a thread);
//      each k32 step of a tile is a fresh accumulator added in float32 on the
//      CUDA cores, the first as acc = acc * corr + pv;
//   4. the epilogue of kernel A: the split's partial (acc / l, m + log(sigma_p
//      l); an empty split (0, -1e30)), then the ticket: the split's last CTA
//      merges the S partials with C's lse_merge (mla_merge.cuh) over the same
//      partial layout and ticket counters; one split writes o and lse itself.
// Sums run in float32 in other orders than the plain version (ref.py), so the
// outputs are not its bits: P's fp8 rounding flips where a logit's last bits
// move. The two are held together within stated tolerances
// (tests/test_torch_sm90_cuda.py).
#include <cuda.h>

#include "common.cuh"
#include "mla_merge.cuh"

namespace snap {
namespace sm90 {

constexpr int kHeads = 64;                   // wgmma M: the heads of one CTA
constexpr int kDc = 512;
constexpr int kDr = 64;
constexpr int kThreads = 256;                // two warpgroups, up to 255 registers a thread
constexpr int kBox = 128;                    // bytes of a swizzled row: one TMA box's width
constexpr int kQTile = kHeads * kBox;        // one [64, 128 B] query tile

// byte offsets into the dynamic shared memory of one CTA; the swizzled tiles
// are 1024-byte aligned (the swizzle's period)
template <int kPage>
struct Smem {
  static constexpr int kStages = kPage == 128 ? 2 : 4;
  static constexpr int kContent = kPage * kDc;         // one page's content
  static constexpr int kRope = kPage * kDr * 2;        // its rope, then its P8 tile
  static constexpr int kTx = kContent + kRope + kPage * 4;   // bytes a page's loads bring
  static constexpr int content = 0;
  static constexpr int rope = content + kStages * kContent;
  static constexpr int q = rope + kStages * kRope;     // 4 fp8 tiles [64, 128]
  static constexpr int qr = q + kHeads * kDc;          // 3 bf16 tiles [64, 64]: hi, mid, lo
  static constexpr int scale = qr + 3 * kQTile;
  static constexpr int red = scale + kStages * kPage * 4;   // [3][2][64]: max, amax, sum e
  static constexpr int head = red + 3 * 2 * kHeads * 4;     // [5][64]: sigma_q, corr, m, l, sp
  static constexpr int bars = head + 5 * kHeads * 4;        // full[kStages]
  static constexpr int flag = bars + kStages * 8;
  static constexpr int total = flag + 16;
  static constexpr int request = total + 1024;   // with room to align the base
  static_assert(kRope >= kHeads * kBox, "the P8 tile fits the rope stage");
  static_assert(rope % 1024 == 0 && q % 1024 == 0 && qr % 1024 == 0, "swizzle alignment");
  static_assert(request <= 227 * 1024, "one CTA's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte-swizzled row r's byte c of a tile with 128-byte rows (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, wgmma's 128-byte swizzle)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

// --- mbarriers, TMA and bulk copies ---
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed; a wait of 2^32
// cycles (over two seconds: no load takes that long) traps, so a fault in
// the pipeline ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1ll << 32)) __trap();
  }
}

// rows [c1, c1 + box rows) from column c0 of a 2-D tensor map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// this thread's writes to shared memory, seen by the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ---
// A K-major operand in 128-byte swizzled rows: the start address, SBO = 1024
// bytes (eight rows), the 128-byte swizzle; a k step of 32 bytes adds 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A . B, float32 D in the m64nN fragment; acc = 0 starts a fresh sum
__device__ __forceinline__ void mma_fp8_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_fp8_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_bf16_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_bf16_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_fp8_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


// QK's two shapes: N = the tokens of one warpgroup (half the page)
template <int N>
__device__ __forceinline__ void mma_fp8(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_fp8_n64(d, a, b, acc);
  else mma_fp8_n32(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_bf16_n64(d, a, b, acc);
  else mma_bf16_n32(d, a, b, acc);
}

// Step 0 for one warp: heads 8 * warp .. 8 * warp + 7 of the group into the
// query tiles and sq_s (rows past nh: zero, sigma_q = 1). Lane l holds the
// content columns 4l + 128j (j < 4) and the rope columns 2l, 2l + 1.
__device__ __forceinline__ void load_query(const uint8_t* __restrict__ q_c8,
                                           const float* __restrict__ q_r,
                                           const float* __restrict__ sigma_q,
                                           const float* __restrict__ q_lat,
                                           const float* __restrict__ q_rope, size_t row0, int nh,
                                           unsigned char* q_s, unsigned char* qr_s, float* sq_s) {
  using Fm = Format<kFp8>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < 8; ++j) {
    const int h = warp * 8 + j;
    const size_t row = row0 + h;
    uint32_t codes[4] = {0, 0, 0, 0};
    float2 r = make_float2(0.f, 0.f);
    float sq = 1.f;
    if (h < nh && q_lat != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(q_lat + row * kDc);
      float4 v[4];
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = src[lane + 32 * k];
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)),
                                 fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
      }
      sq = dynamic_scale<kFp8>(warp_max(amax));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        codes[k] = uint32_t{Fm::cast(__fdiv_rn(v[k].x, sq))} |
                   uint32_t{Fm::cast(__fdiv_rn(v[k].y, sq))} << 8 |
                   uint32_t{Fm::cast(__fdiv_rn(v[k].z, sq))} << 16 |
                   uint32_t{Fm::cast(__fdiv_rn(v[k].w, sq))} << 24;
      const float2 x = reinterpret_cast<const float2*>(q_rope + row * kDr)[lane];
      r = make_float2(__fdiv_rn(x.x, sq), __fdiv_rn(x.y, sq));
    } else if (h < nh) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(q_c8 + row * kDc);
#pragma unroll
      for (int k = 0; k < 4; ++k) codes[k] = src[lane + 32 * k];
      r = reinterpret_cast<const float2*>(q_r + row * kDr)[lane];
      sq = sigma_q[row];
    }
    // bytes 4l .. 4l + 3 of each 128-byte row: content tile k, rope tiles
    const int at = swz(h, 4 * lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) *reinterpret_cast<uint32_t*>(q_s + k * kQTile + at) = codes[k];
    // q_r = hi + mid + lo, each bf16 (round to nearest); every difference is
    // exact in float32 and lo holds the last 8 of the 24 significant bits
    float2 rest = r;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16 x = __float2bfloat16_rn(rest.x), y = __float2bfloat16_rn(rest.y);
      *reinterpret_cast<uint32_t*>(qr_s + t * kQTile + at) =
          uint32_t{__bfloat16_as_ushort(x)} | uint32_t{__bfloat16_as_ushort(y)} << 16;
      rest = make_float2(rest.x - __bfloat162float(x), rest.y - __bfloat162float(y));
    }
    if (lane == 0) sq_s[h] = sq;
  }
}

template <int kPage>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __grid_constant__ CUtensorMap content_map,
              const __grid_constant__ CUtensorMap rope_map, const uint8_t* __restrict__ q_c8,
              const float* __restrict__ q_r, const float* __restrict__ sigma_q,
              const float* __restrict__ q_lat, const float* __restrict__ q_rope,
              const float* __restrict__ scale, const int* __restrict__ page_table,
              const int* __restrict__ seq_lens, float* o_part, float* lse_part,
              float* __restrict__ o_out, float* __restrict__ lse_out, int* __restrict__ tickets,
              int H, int P, int pages_per_split, float softmax_scale) {
  using L = Smem<kPage>;
  constexpr int kStages = L::kStages;
  constexpr int kHalf = kPage / 2;     // the tokens of one warpgroup's QK
  constexpr int kS = kHalf / 2;        // its S registers a thread
  constexpr int kSteps = kPage / 32;   // PV's k steps
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the layout's base, 1024-byte aligned (the launch asks for 1 KB more)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  float* mx_s = reinterpret_cast<float*>(smem + L::red);   // [2][64] per warpgroup
  float* am_s = mx_s + 2 * kHeads;
  float* es_s = am_s + 2 * kHeads;
  float* sq_s = reinterpret_cast<float*>(smem + L::head);
  float* corr_s = sq_s + kHeads;
  float* m_s = corr_s + kHeads;
  float* l_s = m_s + kHeads;
  float* sp_s = l_s + kHeads;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = blockIdx.x * kHeads;
  const int nh = min(kHeads, H - h0);
  const int split = blockIdx.y, S = gridDim.y;
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const int first = split * pages_per_split;
  // the split's live pages (valid tokens are a prefix of the row)
  const int n_live =
      max(0, min(min(first + pages_per_split, P), (seq_len + kPage - 1) / kPage) - first);

  // thread 0 is the producer: page i of the split into stage i mod kStages,
  // the first kStages pages now and page i - 1 + kStages once every thread
  // is done with page i - 1 (the first barrier of page i)
  const int* row = page_table + static_cast<size_t>(b) * P + first;
  auto load = [&](int i) {
    const int s = i % kStages, pid = row[i];
    mbar_expect_tx(full + s, L::kTx);
    unsigned char* c = smem + L::content + s * L::kContent;
#pragma unroll
    for (int j = 0; j < kDc / kBox; ++j)
      tma_load(c + j * kPage * kBox, &content_map, j * kBox, pid * kPage, full + s);
    tma_load(smem + L::rope + s * L::kRope, &rope_map, 0, pid * kPage, full + s);
    bulk_load(smem + L::scale + s * kPage * 4, scale + static_cast<size_t>(pid) * kPage,
              kPage * 4, full + s);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(kStages, n_live); ++i) load(i);
  }

  // warpgroup wg, its warp wi; a thread's fragment rows are gid and gid + 8
  // of its warp's 16, its columns 2 tig, 2 tig + 1 of each 8
  const int wg = warp >> 2, wi = warp & 3, gid = lane >> 2, tig = lane & 3;
  unsigned char* q_s = smem + L::q;
  unsigned char* qr_s = smem + L::qr;
  const size_t row0 = static_cast<size_t>(b) * H + h0;
  load_query(q_c8, q_r, sigma_q, q_lat, q_rope, row0, nh, q_s, qr_s, sq_s);
  fence_async_smem();
  __syncthreads();   // the barriers initialized, the query tiles written

  // the S rows of this thread: heads r0 and r0 + 8, their running state
  const int r0 = 16 * wi + gid;
  float sq[2], m[2], l[2], sp[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    sq[k] = sq_s[r0 + 8 * k];
    m[k] = kNegInf;
    l[k] = 0.f;
    sp[k] = 1.f;
  }
  float acc[4][32];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[t][k] = 0.f;
  const uint64_t dq = sw128_desc(q_s), dqr = sw128_desc(qr_s);

  for (int i = 0; i < n_live; ++i) {
    const int s = i % kStages;
    const int g = first + i;
    mbar_wait(full + s, (i / kStages) & 1);
    __syncwarp();   // the warp converged again before its warpgroup's wgmma
    const unsigned char* cs = smem + L::content + s * L::kContent;
    unsigned char* rs = smem + L::rope + s * L::kRope;
    const float* sk = reinterpret_cast<const float*>(smem + L::scale + s * kPage * 4);

    // 1. QK over this warpgroup's kHalf tokens: the 16 k32 steps over the
    // 512 content columns, each a fresh accumulator added to S in float32
    // (promotion every 32 products), then the rope's three bf16 terms
    float sc[kS], t[kS];
    const uint64_t dc = sw128_desc(cs + wg * kHalf * kBox);
    // step i: columns 32 i .. 32 i + 31, in box i / 4 of the query and the page
    auto qk_step = [&](float (&d)[kS], int i) {
      mma_fp8<kHalf>(d, dq + (((i / 4) * kQTile) >> 4) + 2 * (i % 4),
                     dc + (((i / 4) * kPage * kBox) >> 4) + 2 * (i % 4), 0);
    };
    wgmma_fence();
    qk_step(sc, 0);
#pragma unroll
    for (int i = 1; i < kDc / 32; ++i) {
      if (i > 1) wgmma_fence();
      qk_step(t, i);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(t);
#pragma unroll
      for (int k = 0; k < kS; ++k) sc[k] += t[k];
    }
    const uint64_t dr = sw128_desc(rs + wg * kHalf * kBox);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int k = 0; k < kDr / 16; ++k)
        mma_bf16<kHalf>(t, dqr + ((term * kQTile) >> 4) + 2 * k, dr + 2 * k, term + k);
    wgmma_commit();
    wgmma_wait();
    fence_regs(t);

    // s, masked; the row max over both warpgroups' tokens
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < kHalf / 8; ++c) {
      const int t0 = wg * kHalf + 8 * c + 2 * tig;
      const float2 k2 = *reinterpret_cast<const float2*>(sk + t0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = g * kPage + t0 + e < seq_len;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = 4 * c + 2 * k + e;
          float v = kNegInf;
          if (valid)
            v = __fmul_rn(__fmul_rn(__fadd_rn(sc[x], t[x]), __fmul_rn(sq[k], e ? k2.y : k2.x)),
                          softmax_scale);
          sc[x] = v;
          mx[k] = fmaxf(mx[k], v);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 1));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 2));
      if (tig == 0) mx_s[wg * kHeads + r0 + 8 * k] = mx[k];
    }
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + kStages < n_live) load(i - 1 + kStages);

    // 2. e, p~ = e * sigma_k, and over both warpgroups sum e and max|p~|
    float m_new[2], am[2] = {0.f, 0.f}, es[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k)
      m_new[k] = fmaxf(m[k], fmaxf(mx_s[r0 + 8 * k], mx_s[kHeads + r0 + 8 * k]));
#pragma unroll
    for (int c = 0; c < kHalf / 8; ++c) {
      const int t0 = wg * kHalf + 8 * c + 2 * tig;
      const float2 k2 = *reinterpret_cast<const float2*>(sk + t0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = g * kPage + t0 + e < seq_len;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = 4 * c + 2 * k + e;
          const float ev = valid ? expf(__fsub_rn(sc[x], m_new[k])) : 0.f;
          const float pf = valid ? __fmul_rn(ev, e ? k2.y : k2.x) : 0.f;
          es[k] += ev;
          am[k] = fmaxf(am[k], fabsf(pf));
          sc[x] = pf;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      am[k] = fmaxf(am[k], __shfl_xor_sync(0xffffffffu, am[k], 1));
      am[k] = fmaxf(am[k], __shfl_xor_sync(0xffffffffu, am[k], 2));
      es[k] += __shfl_xor_sync(0xffffffffu, es[k], 1);
      es[k] += __shfl_xor_sync(0xffffffffu, es[k], 2);
      if (tig == 0) {
        am_s[wg * kHeads + r0 + 8 * k] = am[k];
        es_s[wg * kHeads + r0 + 8 * k] = es[k];
      }
    }
    __syncthreads();

    // sigma_p over the page, the state, and P8 into the rope stage, token t
    // at column k_of(t) (both warpgroups' QK wgmmas have completed: each
    // waited before the barriers); p~ / sigma_p as p~ * (1 / sigma_p), which
    // differs from the quotient by an ulp at most, 2^-20 of an fp8 step
    float sp_new[2], inv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = r0 + 8 * k;
      const float esum = __fadd_rn(es_s[r], es_s[kHeads + r]);
      sp_new[k] = dynamic_scale<kFp8>(fmaxf(am_s[r], am_s[kHeads + r]));
      const float corr = __fmul_rn(expf(__fsub_rn(m[k], m_new[k])), sp[k] / sp_new[k]);
      l[k] = __fadd_rn(__fmul_rn(l[k], corr), esum / sp_new[k]);
      m[k] = m_new[k];
      sp[k] = sp_new[k];
      inv[k] = __frcp_rn(sp_new[k]);
      if (wg == 0 && tig == 0) corr_s[r] = corr;
    }
#pragma unroll
    for (int c = 0; c < kHalf / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = wg * kHalf + 8 * c + 2 * tig + e;
        const int col = (tk & ~31) | (tk & 16) | (tk & 3) << 2 | (tk >> 2 & 3);   // k_of(tk)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          rs[swz(r0 + 8 * k, col)] = Format<kFp8>::cast(__fmul_rn(sc[4 * c + 2 * k + e], inv[k]));
      }
    }
    fence_async_smem();
    __syncthreads();

    // 3. PV: acc = acc * corr + C^T . P8^T, this warpgroup's 256 columns in
    // four tiles of 64; a thread's accumulator columns are heads 8q + 2 tig
    // (+ 1), its rows latent columns n0 + 16 wi + gid (+ 8)
    float cr[16];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 c2 = *reinterpret_cast<const float2*>(corr_s + 8 * q + 2 * tig);
      cr[2 * q] = c2.x;
      cr[2 * q + 1] = c2.y;
    }
    const uint64_t dp = sw128_desc(rs);
    // the A fragment of tile mt: rows (latent columns) n0 + 16 wi + gid
    // (+ 8), k 32 ks + 4 tig + e (+ 16), bytes of the swizzled box n0 / 128;
    // k holds token tok_of(k), so a warp's loads of one e fall in 8 banks; a
    // tile's bytes are gathered while the tile before it runs
    auto gather = [&](int mt, uint32_t (&a)[kSteps][4]) {
      const int n0 = wg * 256 + mt * 64;
      const unsigned char* base = cs + (n0 / kBox) * (kPage * kBox) + gid;
      const int chunk = (n0 % kBox) / 16 + wi;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int k = 0; k < 4; ++k) a[ks][k] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tk = 32 * ks + tig + 4 * e;   // tok_of(32 ks + 4 tig + e)
          const unsigned char* p = base + tk * kBox + ((chunk ^ (tk & 7)) << 4);
          a[ks][0] |= uint32_t{p[0]} << (8 * e);
          a[ks][1] |= uint32_t{p[8]} << (8 * e);
          a[ks][2] |= uint32_t{p[16 * kBox]} << (8 * e);
          a[ks][3] |= uint32_t{p[16 * kBox + 8]} << (8 * e);
        }
      }
    };
    uint32_t a[2][kSteps][4];
    gather(0, a[0]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {   // each k32 step a fresh sum, added in float32
        float pv[32];
        wgmma_fence();
        mma_fp8_rs_n64(pv, a[mt & 1][ks], dp + 2 * ks, 0);
        wgmma_commit();
        if (ks == 0 && mt < 3) gather(mt + 1, a[(mt + 1) & 1]);
        wgmma_wait();
        fence_regs(pv);
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float& x = acc[mt][4 * q + k];
            x = ks == 0 ? fmaf(x, cr[2 * q + (k & 1)], pv[4 * q + k]) : x + pv[4 * q + k];
          }
      }
    }
  }

  // 4. the epilogue: (acc / l, m + log(sigma_p l)); an empty split (0, -1e30)
  if (wg == 0 && tig == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      m_s[r0 + 8 * k] = m[k];
      l_s[r0 + 8 * k] = l[k];
      sp_s[r0 + 8 * k] = sp[k];
    }
  }
  __syncthreads();
  // one split: C's merge of one partial is the identity, so the split writes
  // o and lse itself (kernel A's rule)
  const bool direct = S == 1;
  float* o_dst = direct ? o_out : o_part;
  float* lse_dst = direct ? lse_out : lse_part;
  const size_t out0 = (static_cast<size_t>(b) * S + split) * H + h0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = 8 * q + 2 * tig + (k & 1);
        const int n = wg * 256 + mt * 64 + 16 * wi + gid + 8 * (k >> 1);
        if (h < nh) {
          const float lh = l_s[h];
          o_dst[(out0 + h) * kDc + n] = lh > 0.f ? acc[mt][4 * q + k] / lh : 0.f;
        }
      }
  if (tid < nh) {
    const float lh = l_s[tid];
    lse_dst[out0 + tid] = lh > 0.f ? __fadd_rn(m_s[tid], logf(__fmul_rn(sp_s[tid], lh)))
                                   : kNegInf;
  }
  if (direct) return;

  // C folded: the group's last split merges the S partials (mla_decode.cu's
  // ticket epilogue)
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + L::flag);
  if (tid == 0) {
    int* ticket = tickets + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
    const bool last = draw_ticket(ticket) == S - 1;
    if (last) atomicExch(ticket, 0);   // every split has drawn: reset for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  constexpr int N = 4, kPerHead = kDc / N;
  const size_t part0 = static_cast<size_t>(b) * S * H + h0;
  for (int it = tid; it < nh * kPerHead; it += kThreads) {
    const int h = it / kPerHead, c = (it - h * kPerHead) * N;
    float out[N];
    const float lse = lse_merge<N, 8>(o_part + (part0 + h) * kDc + c,
                                      static_cast<size_t>(H) * kDc, lse_part + part0 + h,
                                      static_cast<size_t>(H), S, out);
    store_cols<N>(o_out + (row0 + h) * kDc + c, out);
    if (c == 0) lse_out[row0 + h] = lse;
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, cols] row-major elements of esize bytes, read in 128-byte-swizzled
// boxes of box_rows rows and 128 bytes
static bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t rows,
                     uint64_t cols, int esize, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBox / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kPage>
static cudaError_t launch(const void* q_c8, const void* q_r, const void* sigma_q,
                          const void* q_lat, const void* q_rope, const void* content,
                          const void* rope, const void* scale, const void* page_table,
                          const void* seq_lens, void* o_part, void* lse_part, void* o, void* lse,
                          void* tickets, int B, int H, int n_pages, int P, int num_splits,
                          int pages_per_split, float softmax_scale, cudaStream_t stream) {
  using L = Smem<kPage>;
  auto kern = decode_kernel<kPage>;
  // raise the kernel's dynamic shared-memory limit once, so a later call
  // inside CUDA-graph capture makes no attribute call
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::request);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap content_map, rope_map;
  const uint64_t rows = static_cast<uint64_t>(n_pages) * kPage;
  if (!tile_map(&content_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, content, rows, kDc, 1, kPage) ||
      !tile_map(&rope_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rope, rows, kDr, 2, kPage))
    return cudaErrorInvalidValue;
  const dim3 grid((H + kHeads - 1) / kHeads, num_splits, B);
  kern<<<grid, kThreads, L::request, stream>>>(
      content_map, rope_map, static_cast<const uint8_t*>(q_c8), static_cast<const float*>(q_r),
      static_cast<const float*>(sigma_q), static_cast<const float*>(q_lat),
      static_cast<const float*>(q_rope), static_cast<const float*>(scale),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<float*>(o_part), static_cast<float*>(lse_part), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<int*>(tickets), H, P, pages_per_split,
      softmax_scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace snap

// The sm90 design of kernel A with C folded: an fp8 pool [n_pages, page,
// 512] (page 64 or 128), its bf16 rope [n_pages, page, 64] and scales
// [n_pages, page], a prepared (q_c8, q_r, sigma_q) or raw (q_lat, q_rope)
// query of H heads, the page table [B, P] and seq_lens [B]; o_part [B * S * H
// * 512] and lse_part [B * S * H] are the partials' scratch, tickets (B x head
// groups int32 counters, zero before the launch and after it) the merge's.
// Writes o [B, H, 512] and lse [B, H]. Every pointer 16-byte aligned.
extern "C" int snapmla_decode_sm90(const void* q_c8, const void* q_r, const void* sigma_q,
                                   const void* q_lat, const void* q_rope, const void* content,
                                   const void* rope, const void* scale, const void* page_table,
                                   const void* seq_lens, void* o_part, void* lse_part, void* o,
                                   void* lse, void* tickets, int B, int H, int n_pages, int page,
                                   int P, int num_splits, int pages_per_split,
                                   float softmax_scale, void* stream) {
  using namespace snap;
  const bool raw = q_lat != nullptr;
  if (B < 1 || H < 1 || n_pages < 1 || P < 1 || num_splits < 1 || pages_per_split < 1 ||
      (raw ? q_rope == nullptr : (q_c8 == nullptr || q_r == nullptr || sigma_q == nullptr)) ||
      o == nullptr || lse == nullptr || tickets == nullptr || o_part == nullptr ||
      lse_part == nullptr ||
      !aligned16({content, rope, scale, raw ? q_lat : q_c8, raw ? q_rope : q_r}))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define SNAP_SM90(PAGE)                                                                         \
  sm90::launch<PAGE>(q_c8, q_r, sigma_q, q_lat, q_rope, content, rope, scale, page_table,      \
                     seq_lens, o_part, lse_part, o, lse, tickets, B, H, n_pages, P, num_splits, \
                     pages_per_split, softmax_scale, st)
  const cudaError_t err = page == 128 ? SNAP_SM90(128)
                          : page == 64 ? SNAP_SM90(64)
                                       : cudaErrorInvalidValue;
#undef SNAP_SM90
  return static_cast<int>(err);
}
