// The split partials' merge shared by the MLA decode kernels (mla_decode.cu,
// mla_decode_sm90.cu): C's arithmetic per latent column (lse_merge), the L2
// reads of the other blocks' partials and the ticket that elects the block
// which merges them. Every add, multiply and division is explicit, so each
// call site rounds alike and a folded merge is the standalone C bit for bit.
#pragma once

#include "common.cuh"

namespace snap {

// N (1, 4 or 8) floats at p, read from L2 (ld.global.cg: L1 is not
// coherent across SMs, and the last block of a tile reads what its siblings
// wrote, into a buffer reused by every launch); volatile and clobbering
// memory, so no load moves above the fence and the barrier before it.
template <int N>
__device__ __forceinline__ void load_l2(const float* p, float* v) {
  if constexpr (N == 1) {
    asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v[0]) : "l"(p) : "memory");
  } else {
    static_assert(N % 4 == 0, "one float or groups of four");
#pragma unroll
    for (int k = 0; k < N; k += 4)
      asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[k]), "=f"(v[k + 1]), "=f"(v[k + 2]), "=f"(v[k + 3])
                   : "l"(p + k)
                   : "memory");
  }
}

// Draw a ticket: atomically add one to *p and return its old value, with
// acquire-release semantics at GPU scope — a release of this thread's (and,
// through the barrier before it, its block's) writes before the ticket, an
// acquire of the writes released before the tickets it follows.
__device__ __forceinline__ int draw_ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// C's arithmetic, for one (row, head) and N consecutive latent columns: the
// S split partials o_s at op + s*o_stride and lse_s at lp + s*l_stride give
// out = sum_s w_s o_s / sum_s w_s with w_s = exp(lse_s - max_s lse_s), summed
// in split order; returns lse = max + log(sum_s w_s). The standalone C kernel
// and the split kernel's ticket epilogue both call it; every add and multiply
// is explicit (__fadd_rn / __fmaf_rn / __fdiv_rn), so the two call sites
// round alike and the folded merge is C bit for bit. The loads are issued
// ahead of the arithmetic: all S at once when S <= C, else C splits at a time
// (the order of the sums is the split order all the same).
template <int N, int C>
__device__ __forceinline__ float lse_merge(const float* op, size_t o_stride, const float* lp,
                                           size_t l_stride, int S, float (&out)[N]) {
  float m, den = 0.f, num[N];
#pragma unroll
  for (int k = 0; k < N; ++k) num[k] = 0.f;
  if (S <= C) {
    float l[C], v[C][N];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < S) {
        load_l2<1>(lp + j * l_stride, l + j);
        load_l2<N>(op + j * o_stride, v[j]);
      }
    }
    m = l[0];
#pragma unroll
    for (int j = 1; j < C; ++j)
      if (j < S) m = fmaxf(m, l[j]);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < S) {
        const float w = expf(__fsub_rn(l[j], m));
        den = __fadd_rn(den, w);
#pragma unroll
        for (int k = 0; k < N; ++k) num[k] = __fmaf_rn(w, v[j][k], num[k]);
      }
    }
  } else {
    m = kNegInf;
    for (int s0 = 0; s0 < S; s0 += C) {
      float l[C];
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (s0 + j < S) load_l2<1>(lp + (s0 + j) * l_stride, l + j);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (s0 + j < S) m = s0 + j == 0 ? l[0] : fmaxf(m, l[j]);
    }
    for (int s0 = 0; s0 < S; s0 += C) {
      float l[C], v[C][N];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (s0 + j < S) {
          load_l2<1>(lp + (s0 + j) * l_stride, l + j);
          load_l2<N>(op + (s0 + j) * o_stride, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (s0 + j < S) {
          const float w = expf(__fsub_rn(l[j], m));
          den = __fadd_rn(den, w);
#pragma unroll
          for (int k = 0; k < N; ++k) num[k] = __fmaf_rn(w, v[j][k], num[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = __fdiv_rn(num[k], den);
  return __fadd_rn(m, logf(den));
}

// out[0 .. N) to dst: one float, or float4 stores (dst 16-byte aligned).
template <int N>
__device__ __forceinline__ void store_cols(float* dst, const float (&out)[N]) {
  if constexpr (N == 1) {
    dst[0] = out[0];
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(dst + k) = make_float4(out[k], out[k + 1], out[k + 2],
                                                        out[k + 3]);
  }
}

}  // namespace snap
