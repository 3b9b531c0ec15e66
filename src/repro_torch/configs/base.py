"""ModelConfig for the port: the fields of ``repro/configs/base.py`` that the
ported serving paths read (the reference's module imports its MoE module,
which imports JAX, so the port keeps its own copy, and its own
``MoEConfig`` in ``models/moe.py``).

Layer heterogeneity is ``layer_pattern``, tiled over ``n_layers`` as in the
reference: ``n_superblocks`` full tiles of the pattern, then the
``remainder_kinds`` (the first ``n_layers % pattern_len`` kinds of the
pattern). Kinds: ``attn`` (full causal GQA), ``swa`` (sliding-window GQA
over a ring-buffer cache), ``mla``, ``cross`` (llama-vision's tanh-gated
cross attention + MLP), ``dec`` (whisper's decoder block: self attention,
cross attention, MLP), ``rglru`` and ``mlstm`` / ``slstm`` (no MLP). The
encoder families read precomputed frame / patch embeddings of
``n_aux_tokens`` rows; whisper runs them through ``encoder_layers``
bidirectional layers first."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_c: int = 512
    d_rope: int = 64
    q_lora_rank: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | mla | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                  # for 'swa' layers
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"
    moe: MoEConfig | None = None     # if set, the MLPs are MoE
    # deepseek: the first k layers dense. The reference passes first_k_dense
    # itself as every layer's index hint (transformer.py:126, :133), so every
    # MLP is MoE whenever ``moe`` is set; the port keeps that
    first_k_dense: int = 0
    mla: MLADims | None = None
    # enc-dec / multimodal stub (precomputed frame / patch embeddings)
    encoder_layers: int = 0          # whisper transformer encoder depth
    n_aux_tokens: int = 0            # encoder frames (whisper) / image patches (vlm)
    # serving / quantized KV cache (the paper's technique)
    kv_fmt: str = "fp8_e4m3"         # fp8_e4m3 | int8 | none (bf16 baseline)
    page_size: int = 128
    # split-KV decode: 0 = context-length heuristic, 1 = single pass, >1 fixed
    kv_splits: int = 0
    # contiguous caches' decode KV block: 0 = page_size, >0 = override (must
    # divide the cache capacity); paged pools' block is their page
    kv_block_n: int = 0
    # per-block accumulator rescale of the decode kernels: "fma" | "amla"
    kv_rescale: str = "fma"
    # P-Cast sink guard: the first k tokens' latent rows kept in full
    # precision (contiguous caches only; 0 = off)
    kv_sink_tokens: int = 0
    # paged KV pool for 'mla' layers instead of the contiguous per-slot cache
    kv_paged: bool = False
    # >0: the paged pool is the serving engine's SHARED multi-tenant pool of
    # this many physical pages, its page table initially all on the page-0
    # scratch page (the allocator writes the rows); 0 = batch-owned layout
    kv_pool_pages: int = 0
    # >0: the serving engine admits prompts in chunks of this many tokens
    # (bucketed to powers of two), later chunks reading earlier ones back
    # from the FP8 pool through the fused fetch-dequant kernel; 0 = one-shot
    # prefill
    prefill_chunk: int = 0
    # consulted by decode_backend == "auto": the Hopper kernels vs the plain ref
    use_kernels: bool = False
    # "auto" | "ref" | "kernel" | an exact backend name
    decode_backend: str = "auto"
    # the dry run's shape grid (``launch/steps.shape_applicable``)
    subquadratic: bool = False       # can run the long_500k decode
    has_decoder: bool = True         # an encoder-only arch would be False
    max_seq_len: int = 131072
    tie_embeddings: bool = True

    def scaled(self, **overrides) -> "ModelConfig":
        """This config with ``overrides`` replaced (base.py:191), e.g.
        ``n_layers`` to cut the depth of a dry-run cell. The reference's
        ``cost_exact`` flag has no counterpart: it unrolls the reference's
        ``lax.scan`` over layers and flash blocks so that XLA's cost analysis
        counts every iteration, and the port's layers are a Python list and
        its flash blocks a Python loop, so every count here is at full depth
        already."""
        return dataclasses.replace(self, **overrides)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def remainder_kinds(self) -> Tuple[str, ...]:
        return self.layer_pattern[:self.n_layers % self.pattern_len]

    @property
    def has_mlp(self) -> bool:
        return self.d_ff > 0 or self.moe is not None

    def param_count(self) -> int:
        """Parameters by the reference's count (base.py:124; ``rglru`` and
        the xLSTM cells approximately, as there), embedding and encoder
        included."""
        d = self.d_model
        kinds = self.layer_kinds
        emb = self.vocab_size * d
        n_attn = sum(k in ("attn", "swa", "dec") for k in kinds)
        n_cross = sum(k in ("cross", "dec") for k in kinds)
        n_mla = sum(k == "mla" for k in kinds)
        n_xlstm = sum(k in ("mlstm", "slstm") for k in kinds)
        attn_p = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        total = emb + (n_attn + n_cross) * attn_p
        if self.mla:
            m = self.mla
            q_in = m.q_lora_rank or d
            total += n_mla * ((d * m.q_lora_rank if m.q_lora_rank else 0)
                              + q_in * self.n_heads * (self.d_head + m.d_rope)
                              + d * (m.d_c + m.d_rope)
                              + 2 * m.d_c * self.n_heads * self.d_head
                              + self.n_heads * self.d_head * d)
        total += sum(k == "rglru" for k in kinds) * 5 * d * d      # d_rnn = d
        total += n_xlstm * 8 * d * self.n_heads * self.d_head
        n_mlp = len(kinds) - n_xlstm if self.has_mlp else 0
        if self.moe is not None:
            dense = min(self.first_k_dense, n_mlp)
            e = self.moe
            total += dense * 3 * d * self.d_ff + (n_mlp - dense) * (
                d * e.n_experts + 3 * d * e.d_ff_expert * (e.n_experts + e.n_shared_experts))
        elif self.d_ff:
            total += n_mlp * 3 * d * self.d_ff
        total += self.encoder_layers * (attn_p + 3 * d * self.d_ff)
        if not self.tie_embeddings:
            total += emb
        return int(total)

    def active_param_count(self) -> int:
        """Parameters one token activates (the top-k experts of each MoE
        layer in place of all of them)."""
        if self.moe is None:
            return self.param_count()
        moe_layers = self.n_layers - min(self.first_k_dense, self.n_layers)
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        return int(self.param_count()
                   - moe_layers * per_expert * (self.moe.n_experts - self.moe.top_k))

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's kind in stack order: the superblocks, then the
        remainder (``transformer.py:112-140`` of the reference)."""
        return self.layer_pattern * self.n_superblocks + self.remainder_kinds
