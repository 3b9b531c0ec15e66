"""Decoder stack of the port — the MLA path of ``repro/models/transformer.py``:
``init_model``, ``init_decode_state``, ``prefill``, ``decode_step`` and
``_mla_decode``, over the contiguous ``MLACache`` (the default) or the paged
pool (``kv_paged``).

The reference stacks its layers along a leading ``scanned`` axis; the port
keeps a list: ``params["layers"][i]`` is one layer's
``{"ln1", "mixer": MLAParams, "ln2", "mlp": MLPParams}`` and
``state["layers"][i]`` its ``MLACache`` or ``PagedMLAPool``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mla as mla_lib
from repro_torch.core.kvcache import (CacheConfig, init_mla_cache, init_paged_mla_cache,
                                      mla_append, mla_prefill, paged_mla_append,
                                      paged_mla_prefill)
from repro_torch.kernels.mla_decode import backends as BK
from repro_torch.kernels.mla_decode import ref as mla_kref
from repro_torch.kernels.quantize.ops import fused_q_quant
from repro_torch.models import layers as L


def _check_mla(cfg: ModelConfig) -> None:
    if cfg.layer_pattern != ("mla",) or cfg.mla is None:
        raise NotImplementedError(f"{cfg.name}: only dense MLA models are ported "
                                  "(layer_pattern ('mla',))")


def _mla_cfg(cfg: ModelConfig) -> mla_lib.MLAConfig:
    m = cfg.mla
    return mla_lib.MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                             d_head=cfg.d_head, d_rope=m.d_rope, d_c=m.d_c,
                             q_lora_rank=m.q_lora_rank, rope_theta=cfg.rope_theta)


def _cache_cfg(cfg: ModelConfig) -> CacheConfig:
    # the sink guard arms only on contiguous MLA caches (transformer.py:64-70)
    return CacheConfig(fmt=cfg.kv_fmt, page_size=cfg.page_size,
                       sink_tokens=0 if cfg.kv_paged else cfg.kv_sink_tokens)


def init_model(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict[str, Any]:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``)."""
    _check_mla(cfg)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "mixer": mla_lib.init_mla_params(gen, _mla_cfg(cfg), dtype, device),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "mlp": L.init_mlp_params(gen, cfg.d_model, cfg.d_ff, True, dtype, device),
        })
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "layers": layers,
    }


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict[str, Any]:
    _check_mla(cfg)
    init = init_paged_mla_cache if cfg.kv_paged else init_mla_cache
    layers = [init(_cache_cfg(cfg), batch, max_len, cfg.mla.d_c, cfg.mla.d_rope,
                   device=device)
              for _ in range(cfg.n_layers)]
    return {"layers": layers}


def _apply_mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), cfg.act)


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding of the final normed hidden state: [B, V] f32."""
    x = L.rms_norm(x, params["ln_f"])
    return torch.einsum("bd,vd->bv", x.float(), params["embed"].float())


def _mla_decode(p: mla_lib.MLAParams, cfg: ModelConfig, x_t: torch.Tensor, cache,
                pos: torch.Tensor, active: torch.Tensor | None = None):
    """SnapMLA decode: cache append + Fused-Q-Quant + backend attention.

    The reference runs ``prepare_q`` here (transformer.py:421); on a kernel
    backend the port sends the query through ``fused_q_quant`` instead,
    which computes the same function (quantize/ref.py:10-19 and
    ref.py:528-537 both call ``quantize_rope_aware``)."""
    mcfg = _mla_cfg(cfg)
    ccfg = _cache_cfg(cfg)
    backend = BK.resolve_backend(cfg.decode_backend, paged=cfg.kv_paged,
                                 use_kernels=cfg.use_kernels)
    c_kv, k_r = mla_lib.project_kv(p, mcfg, x_t[:, None, :], pos[:, None])
    append = paged_mla_append if cfg.kv_paged else mla_append
    cache = append(cache, ccfg, c_kv[:, 0], k_r[:, 0], active=active)
    q_c, q_r = mla_lib.project_q(p, mcfg, x_t[:, None, :], pos[:, None])
    if active is not None:
        # finished rows: zero the query (EPS keeps the scale finite)
        q_c = torch.where(active[:, None, None, None], q_c, 0.0)
        q_r = torch.where(active[:, None, None, None], q_r, 0.0)
    q_lat = mla_lib.absorb_q(p, q_c[:, 0])
    fmt = ccfg.fmt if ccfg.quantized else "none"
    if fmt != "none" and backend.kind == "kernel":
        q_cat = torch.cat([q_lat.float(), q_r[:, 0].float()], dim=-1)
        q_c8, q_r_s, sigma_q = fused_q_quant(q_cat, mcfg.d_c, fmt=fmt)
    else:
        q_c8, q_r_s, sigma_q = mla_kref.prepare_q(q_lat, q_r[:, 0], fmt)
    bcfg = BK.BackendConfig(softmax_scale=mcfg.softmax_scale,
                            block_n=cfg.kv_block_n or ccfg.page_size, fmt=fmt,
                            num_splits=cfg.kv_splits, rescale=cfg.kv_rescale)
    o_lat = backend.decode(BK.DecodeQuery(q_c8, q_r_s, sigma_q), cache, bcfg)
    return mla_lib.output_proj(p, o_lat.to(x_t.dtype)), cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state,
                pos: torch.Tensor, active: torch.Tensor | None = None):
    """token [B] int, pos [B] int -> (logits [B, V] f32, new state).

    ``active`` [B] bool (optional) marks rows still generating: inactive rows
    skip their cache append and run with zeroed queries."""
    _check_mla(cfg)
    x_t = L.embed(params["embed"], token)
    new_layers = []
    for p, cache in zip(params["layers"], state["layers"]):
        h = L.rms_norm(x_t, p["ln1"])
        y, cache = _mla_decode(p["mixer"], cfg, h, cache, pos, active)
        x_t = _apply_mlp(p, cfg, x_t + y)
        new_layers.append(cache)
    return _logits(params, x_t), {**state, "layers": new_layers}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, state):
    """tokens [B, S] -> (last-token logits [B, V], filled decode state)."""
    _check_mla(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    mcfg = _mla_cfg(cfg)
    fill = paged_mla_prefill if cfg.kv_paged else mla_prefill
    new_layers = []
    for p, cache in zip(params["layers"], state["layers"]):
        h = L.rms_norm(x, p["ln1"])
        x = x + mla_lib.mla_attention(p["mixer"], mcfg, h, positions)
        c_kv, k_r = mla_lib.project_kv(p["mixer"], mcfg, h, positions)
        new_layers.append(fill(cache, _cache_cfg(cfg), c_kv, k_r))
        x = _apply_mlp(p, cfg, x)
    return _logits(params, x[:, -1]), {**state, "layers": new_layers}
