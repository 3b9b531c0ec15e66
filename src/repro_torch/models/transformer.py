"""Decoder stack of the port — the MLA path of ``repro/models/transformer.py``:
``init_model``, ``init_decode_state``, ``prefill``, ``decode_step`` and
``_mla_decode``, over the contiguous ``MLACache`` (the default) or the paged
pool (``kv_paged``; the serving engine's shared pool with ``kv_pool_pages``),
and the serving engine's two paged steps: ``chunked_prefill`` (one prompt
chunk, its prefix read back through the fused fetch-dequant kernel) and
``verify_step`` (a K-token speculative block through the q_len > 1 split-KV
kernel).

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
                                      paged_mla_prefill, paged_mla_prefill_at)
from repro_torch.kernels.mla_decode import backends as BK
from repro_torch.kernels.mla_decode import ref as mla_kref
from repro_torch.kernels.quantize import fetch_dequant as FD
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
    ccfg = _cache_cfg(cfg)
    dims = (cfg.mla.d_c, cfg.mla.d_rope)
    if cfg.kv_paged:
        # kv_pool_pages > 0: the engine's shared pool (transformer.py:266-270)
        layers = [init_paged_mla_cache(ccfg, batch, max_len, *dims, device=device,
                                       n_pages=cfg.kv_pool_pages)
                  for _ in range(cfg.n_layers)]
    else:
        layers = [init_mla_cache(ccfg, batch, max_len, *dims, device=device)
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
    o_lat = backend.decode(_prepare_query(q_lat, q_r[:, 0], ccfg, backend),
                           cache, _backend_cfg(cfg, mcfg, ccfg))
    return mla_lib.output_proj(p, o_lat.to(x_t.dtype)), cache


def _prepare_query(q_lat: torch.Tensor, q_r: torch.Tensor, ccfg: CacheConfig,
                   backend: BK.DecodeBackend) -> BK.DecodeQuery:
    """Quantize [B, (K,) H, .] queries: Fused-Q-Quant (kernel D) on a kernel
    backend, ``prepare_q`` otherwise — the same function (quantize/ref.py and
    ref.py:528-537 both call ``quantize_rope_aware``)."""
    fmt = ccfg.fmt if ccfg.quantized else "none"
    shape = q_lat.shape[:-1]
    q_lat = q_lat.reshape(shape[0], -1, q_lat.shape[-1])
    q_r = q_r.reshape(shape[0], -1, q_r.shape[-1])
    if fmt != "none" and backend.kind == "kernel":
        q_cat = torch.cat([q_lat.float(), q_r.float()], dim=-1)
        q_c8, q_r_s, sigma_q = fused_q_quant(q_cat, q_lat.shape[-1], fmt=fmt)
    else:
        q_c8, q_r_s, sigma_q = mla_kref.prepare_q(q_lat, q_r, fmt)
    return BK.DecodeQuery(q_c8.reshape(*shape, -1), q_r_s.reshape(*shape, -1),
                          sigma_q.reshape(shape))


def _backend_cfg(cfg: ModelConfig, mcfg, ccfg: CacheConfig) -> BK.BackendConfig:
    return BK.BackendConfig(softmax_scale=mcfg.softmax_scale,
                            block_n=cfg.kv_block_n or ccfg.page_size,
                            fmt=ccfg.fmt if ccfg.quantized else "none",
                            num_splits=cfg.kv_splits, rescale=cfg.kv_rescale)


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


def _check_paged_mla(cfg: ModelConfig, what: str) -> None:
    _check_mla(cfg)
    if not cfg.kv_paged:
        raise ValueError(f"{what} drives the paged MLA pipeline; kv_paged=False "
                         "is unsupported")


def _chunked_prefill_mla_layer(p, cfg: ModelConfig, x: torch.Tensor, pool,
                               chunk_start: torch.Tensor, valid: torch.Tensor):
    """One MLA layer over one prompt chunk (transformer.py:637-659): land the
    chunk's quantized KV in the pool at ``chunk_start + t``, then attend its
    queries against [the FP8 prefix pages, read back by the bounded fetch] +
    [the chunk at full precision], causal."""
    mcfg = _mla_cfg(cfg)
    C = x.shape[1]
    positions = chunk_start.long()[:, None] + torch.arange(C, device=x.device)[None, :]
    h = L.rms_norm(x, p["ln1"])
    m = p["mixer"]
    c_kv, k_r = mla_lib.project_kv(m, mcfg, h, positions)
    pool = paged_mla_prefill_at(pool, _cache_cfg(cfg), c_kv, k_r, chunk_start, valid)
    q_c, q_r = mla_lib.project_q(m, mcfg, h, positions)
    o_lat = FD.paged_chunked_prefill_attention(
        mla_lib.absorb_q(m, q_c), q_r, pool, c_kv, k_r, chunk_start, valid,
        softmax_scale=mcfg.softmax_scale, use_kernel=cfg.use_kernels)
    x = x + mla_lib.output_proj(m, o_lat.to(x.dtype))
    return _apply_mlp(p, cfg, x), pool


def chunked_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, state,
                    chunk_start: torch.Tensor, last_idx: torch.Tensor):
    """One prompt chunk through the stack (transformer.py:662-725): tokens
    [B, C] at positions ``chunk_start + t`` -> (logits [B, V] at the chunk's
    last real token ``last_idx``, state with the chunk landed in the pool).
    Positions past ``last_idx`` are bucket padding: written to the scratch
    page and masked out of the attention. Paged MLA only."""
    _check_paged_mla(cfg, "chunked_prefill")
    C = tokens.shape[1]
    valid = torch.arange(C, device=tokens.device)[None, :] <= last_idx.long()[:, None]
    x = L.embed(params["embed"], tokens)
    new_layers = []
    for p, pool in zip(params["layers"], state["layers"]):
        x, pool = _chunked_prefill_mla_layer(p, cfg, x, pool, chunk_start, valid)
        new_layers.append(pool)
    x_last = torch.gather(x, 1, last_idx.long()[:, None, None].expand(-1, 1, x.shape[-1]))
    return _logits(params, x_last[:, 0]), {**state, "layers": new_layers}


def _verify_mla_layer(p, cfg: ModelConfig, x: torch.Tensor, pool, start: torch.Tensor):
    """One MLA layer over a K-token verify block (transformer.py:732-770):
    land the block's quantized entries at ``start + t`` (the bytes a
    sequential decode would append; past the table span they go to the
    scratch page), then attend all K queries against the pool through the
    q_len > 1 split-KV backend, causal across the block by the per-row
    limits."""
    mcfg = _mla_cfg(cfg)
    ccfg = _cache_cfg(cfg)
    B, K = x.shape[:2]
    positions = start.long()[:, None] + torch.arange(K, device=x.device)[None, :]
    h = L.rms_norm(x, p["ln1"])
    m = p["mixer"]
    c_kv, k_r = mla_lib.project_kv(m, mcfg, h, positions)
    valid = torch.ones((B, K), dtype=torch.bool, device=x.device)
    pool = paged_mla_prefill_at(pool, ccfg, c_kv, k_r, start, valid)
    q_c, q_r = mla_lib.project_q(m, mcfg, h, positions)
    backend = BK.resolve_backend(cfg.decode_backend, paged=True,
                                 use_kernels=cfg.use_kernels, q_len=K)
    query = _prepare_query(mla_lib.absorb_q(m, q_c), q_r, ccfg, backend)
    o_lat = backend.decode(query, pool, _backend_cfg(cfg, mcfg, ccfg))   # [B, K, H, d_c]
    x = x + mla_lib.output_proj(m, o_lat.to(x.dtype))
    return _apply_mlp(p, cfg, x), pool


def verify_step(params, cfg: ModelConfig, tokens: torch.Tensor, state,
                start: torch.Tensor):
    """Self-speculative verify (transformer.py:773-828): tokens [B, K] (row 0
    the slot's last committed token, then the drafts) at positions
    ``start + t`` -> (logits [B, K, V] at every position, state with the
    block's entries in the pool). Rejected entries are masked by the next
    step's ``seq_lens``. Paged MLA only."""
    _check_paged_mla(cfg, "verify_step")
    x = L.embed(params["embed"], tokens)
    new_layers = []
    for p, pool in zip(params["layers"], state["layers"]):
        x, pool = _verify_mla_layer(p, cfg, x, pool, start)
        new_layers.append(pool)
    x = L.rms_norm(x, params["ln_f"])
    logits = torch.einsum("bkd,vd->bkv", x.float(), params["embed"].float())
    return logits, {**state, "layers": new_layers}
