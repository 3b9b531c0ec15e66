"""SnapMLA single-layer public API (port of ``repro/core/snapmla.py``), over a
contiguous ``MLACache`` (the default) or a batch-owned ``PagedMLAPool``.

  prefill():      exact prompt attention, then bulk RoPE-aware per-token
                  quantization of the prompt's latent/rope entries into the cache.
  decode_step():  project_kv -> Fused-K-Append (contiguous, quantized) or the
                  append -> project_q -> absorb -> Fused-Q-Quant -> backend
                  decode -> W_UV·W_O output projection.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mla as mla_lib
from repro_torch.core.kvcache import (CacheConfig, MLACache, PagedMLAPool, init_mla_cache,
                                      init_paged_mla_cache, mla_append, mla_prefill,
                                      paged_mla_append, paged_mla_prefill)
from repro_torch.kernels.mla_decode import backends as mla_backends
from repro_torch.kernels.mla_decode import ref as mla_ref
from repro_torch.kernels.quantize.ops import fused_k_append, fused_q_quant


@dataclasses.dataclass(frozen=True)
class SnapMLAConfig:
    mla: mla_lib.MLAConfig
    cache: CacheConfig = CacheConfig()
    # True = the Hopper kernels (plain versions on CPU tensors), False = the
    # plain PyTorch reference backend
    use_kernel: bool = True
    # None/0 = context-length heuristic, 1 = single pass, >1 = fixed splits
    num_splits: int | None = None
    # contiguous-cache decode block: 0 = cache.page_size; paged pools are
    # pinned to the page size
    block_n: int = 0
    # per-block accumulator rescale: "fma" | "amla"
    rescale: str = "fma"
    # True: the cache is a PagedMLAPool rather than a contiguous MLACache
    paged: bool = False

    @property
    def fmt(self) -> str:
        return self.cache.fmt


def init_cache(cfg: SnapMLAConfig, batch: int, max_len: int, device=None):
    """An MLACache, or a batch-owned PagedMLAPool when ``cfg.paged``."""
    init = init_paged_mla_cache if cfg.paged else init_mla_cache
    return init(cfg.cache, batch, max_len, cfg.mla.d_c, cfg.mla.d_rope, device=device)


def prefill(params: mla_lib.MLAParams, cfg: SnapMLAConfig, h: torch.Tensor,
            cache) -> tuple[torch.Tensor, "MLACache | PagedMLAPool"]:
    """Run exact prompt attention and fill the quantized cache."""
    positions = torch.arange(h.shape[1], device=h.device)
    out = mla_lib.mla_attention(params, cfg.mla, h, positions, causal=True)
    c_kv, k_r = mla_lib.project_kv(params, cfg.mla, h, positions)
    fill = paged_mla_prefill if isinstance(cache, PagedMLAPool) else mla_prefill
    return out, fill(cache, cfg.cache, c_kv, k_r)


def decode_step(params: mla_lib.MLAParams, cfg: SnapMLAConfig, h_t: torch.Tensor,
                cache) -> tuple[torch.Tensor, "MLACache | PagedMLAPool"]:
    """One decode step: returns (attention output [B, d], updated cache)."""
    positions = cache.seq_lens.long()                    # 0-based position of h_t
    paged = isinstance(cache, PagedMLAPool)

    # -- K side: project + Fused-K-Append (quantize + align + write) --------
    c_kv, k_r = mla_lib.project_kv(params, cfg.mla, h_t[:, None, :], positions[:, None])
    if paged:
        cache = paged_mla_append(cache, cfg.cache, c_kv[:, 0], k_r[:, 0])
    elif cfg.cache.quantized:
        cache = fused_k_append(cache, c_kv[:, 0], k_r[:, 0], fmt=cfg.fmt,
                               use_kernel=cfg.use_kernel)
    else:
        cache = mla_append(cache, cfg.cache, c_kv[:, 0], k_r[:, 0])

    # -- Q side: project + absorb + Fused-Q-Quant ----------------------------
    q_c, q_r = mla_lib.project_q(params, cfg.mla, h_t[:, None, :], positions[:, None])
    q_lat = mla_lib.absorb_q(params, q_c[:, 0])         # [B, H, d_c]
    q_rope = q_r[:, 0]                                  # [B, H, d_r]
    if cfg.cache.quantized:
        q_cat = torch.cat([q_lat.float(), q_rope.float()], dim=-1)
        q_c8, q_r_s, sigma_q = fused_q_quant(q_cat, cfg.mla.d_c, fmt=cfg.fmt,
                                             use_kernel=cfg.use_kernel)
    else:
        q_c8, q_r_s, sigma_q = mla_ref.prepare_q(q_lat, q_rope, "none")

    # -- SnapMLA decode attention: backend-registry dispatch -----------------
    backend = mla_backends.resolve_backend(
        "kernel" if cfg.use_kernel else "ref", paged=paged)
    bcfg = mla_backends.BackendConfig(
        softmax_scale=cfg.mla.softmax_scale, block_n=cfg.block_n or cfg.cache.page_size,
        fmt=cfg.fmt if cfg.cache.quantized else "none", num_splits=cfg.num_splits,
        rescale=cfg.rescale)
    o_lat = backend.decode(mla_backends.DecodeQuery(q_c8, q_r_s, sigma_q), cache, bcfg)
    return mla_lib.output_proj(params, o_lat.to(h_t.dtype)), cache
