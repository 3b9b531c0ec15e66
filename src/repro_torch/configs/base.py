"""ModelConfig for the port: the fields of ``repro/configs/base.py`` that the
MLA serving path reads (the reference's module imports its MoE module, which
imports JAX, so the port keeps its own copy). Embeddings are tied, as in
every MLA config of the reference."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_c: int = 512
    d_rope: int = 64
    q_lora_rank: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 10000.0
    act: str = "silu"
    mla: MLADims | None = None
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
    # consulted by decode_backend == "auto": the Hopper kernels vs the plain ref
    use_kernels: bool = False
    # "auto" | "ref" | "kernel" | an exact backend name
    decode_backend: str = "auto"
