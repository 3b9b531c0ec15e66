"""SnapMLA single-layer public API over a paged pool (port of
``repro/core/snapmla.py``; the contiguous cache is not ported yet, so the
pool is always paged and the config has no ``paged`` switch).

  prefill():      exact prompt attention, then bulk RoPE-aware per-token
                  quantization of the prompt's latent/rope entries into the pool.
  decode_step():  project_kv -> paged append -> project_q -> absorb ->
                  Fused-Q-Quant -> backend decode -> W_UV·W_O output projection.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mla as mla_lib
from repro_torch.core.kvcache import (CacheConfig, PagedMLAPool, init_paged_mla_cache,
                                      paged_mla_append, paged_mla_prefill)
from repro_torch.kernels.mla_decode import backends as mla_backends
from repro_torch.kernels.mla_decode import ref as mla_ref
from repro_torch.kernels.quantize.ops import fused_q_quant


@dataclasses.dataclass(frozen=True)
class SnapMLAConfig:
    mla: mla_lib.MLAConfig
    cache: CacheConfig = CacheConfig()
    # True = the Hopper kernels (plain versions on CPU tensors), False = the
    # plain PyTorch reference backend
    use_kernel: bool = True
    # None/0 = context-length heuristic, 1 = single pass, >1 = fixed splits
    num_splits: int | None = None

    @property
    def fmt(self) -> str:
        return self.cache.fmt


def init_cache(cfg: SnapMLAConfig, batch: int, max_len: int, device=None) -> PagedMLAPool:
    """A batch-owned PagedMLAPool."""
    return init_paged_mla_cache(cfg.cache, batch, max_len, cfg.mla.d_c,
                                cfg.mla.d_rope, device=device)


def prefill(params: mla_lib.MLAParams, cfg: SnapMLAConfig, h: torch.Tensor,
            cache: PagedMLAPool) -> tuple[torch.Tensor, PagedMLAPool]:
    """Run exact prompt attention and fill the quantized pool."""
    positions = torch.arange(h.shape[1], device=h.device)
    out = mla_lib.mla_attention(params, cfg.mla, h, positions, causal=True)
    c_kv, k_r = mla_lib.project_kv(params, cfg.mla, h, positions)
    return out, paged_mla_prefill(cache, cfg.cache, c_kv, k_r)


def decode_step(params: mla_lib.MLAParams, cfg: SnapMLAConfig, h_t: torch.Tensor,
                cache: PagedMLAPool) -> tuple[torch.Tensor, PagedMLAPool]:
    """One decode step: returns (attention output [B, d], updated pool)."""
    positions = cache.seq_lens.long()                    # 0-based position of h_t

    # -- K side: project + paged append (quantize + align + scatter) --------
    c_kv, k_r = mla_lib.project_kv(params, cfg.mla, h_t[:, None, :], positions[:, None])
    cache = paged_mla_append(cache, cfg.cache, c_kv[:, 0], k_r[:, 0])

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
        "kernel" if cfg.use_kernel else "ref", paged=True)
    bcfg = mla_backends.BackendConfig(
        softmax_scale=cfg.mla.softmax_scale,
        fmt=cfg.fmt if cfg.cache.quantized else "none", num_splits=cfg.num_splits)
    o_lat = backend.decode(mla_backends.DecodeQuery(q_c8, q_r_s, sigma_q), cache, bcfg)
    return mla_lib.output_proj(params, o_lat.to(h_t.dtype)), cache
