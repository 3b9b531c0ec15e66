"""Decoder stack of the port (``repro/models/transformer.py``) for every
layer kind of the reference: ``attn`` (full causal GQA), ``swa``
(sliding-window GQA over a ring-buffer cache), ``mla``, ``cross``
(llama-vision's tanh-gated cross attention + MLP), ``dec`` (whisper's
decoder block: self attention, cross attention, MLP), ``rglru`` (the RG-LRU
recurrence, ``models/rglru.py``) and ``mlstm`` / ``slstm`` (the xLSTM cells,
``models/xlstm.py``): ``init_model``, ``init_decode_state``, ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` over any pattern of those
kinds; and, for pure-MLA models over the paged pool, the serving engine's
two paged steps: ``chunked_prefill`` (one prompt chunk, its prefix read back
through the fused fetch-dequant kernel) and ``verify_step`` (a K-token
speculative block through the q_len > 1 split-KV kernel).

MLA layers decode through the contiguous ``MLACache`` (the default) or the
paged pool (``kv_paged``; the serving engine's shared pool with
``kv_pool_pages``). GQA layers decode through a ``GQACache`` and the FP8 GQA
decode (``kernels/gqa_decode``): the CUDA kernel #7 under the ``kernel``
backend, the parallel form ``gqa_decode_parallel_ref`` under ``ref``, as
the reference's model path does (transformer.py:351); the MLA-only fields
(``kv_paged``, ``kv_splits``, ``kv_block_n``, ``kv_rescale``,
``kv_sink_tokens``) do nothing on GQA layers, as in the reference.

The encoder families read ``aux_embed`` [B, n_aux_tokens, d] (precomputed
frame / patch embeddings); whisper first runs it through its
``encoder_layers`` bidirectional layers (``_run_encoder``). Prefill keeps
the result in ``state["aux"]`` and projects it once into each cross layer's
static ``GQACache`` (``_fill_cross_cache``: capacity ``n_aux_tokens``
rounded up to the page, slots past it empty); a decode step attends that
cache through the same GQA decode as a self-attention layer, at a position
past every slot (``_cross_decode``), and never writes it.

Each layer's MLP is dense, or with ``cfg.moe`` the token-choice MoE
(``models/moe.py``): ``forward`` returns the summed dropped fraction as its
auxiliary, and the serving paths discard it, as the reference's do. The
``mlstm`` and ``slstm`` blocks are self-contained and have no MLP
(transformer.py:103). A recurrent layer's state is its ``RGLRUState``,
``MLSTMState`` or ``SLSTMState``; prefill recomputes it from the prompt,
and a decode step with ``active`` keeps the rows of finished sequences
frozen (``_freeze_inactive``).

The reference stacks each pattern slot's layers along a leading ``scanned``
axis and keeps the remainder in ``tail``; the port keeps one list in layer
order (``cfg.layer_kinds``): ``params["layers"][i]`` is one layer's
``{"ln1", "mixer": AttnParams | MLAParams | RGLRUParams | MLSTMParams |
SLSTMParams, ("xgate",) ("ln_cross", "cross": AttnParams,) ("ln2", "mlp":
MLPParams | MoEParams)}`` and ``state["layers"][i]`` its ``GQACache``,
``MLACache``, ``PagedMLAPool``, recurrent state, or for ``dec`` the dict
``{"self": GQACache, "cross": GQACache}``; ``params["encoder"]`` lists the
encoder's ``attn`` layers. ``forward`` runs each superblock (the pattern's
layers) under ``torch.utils.checkpoint`` when ``remat``, as the reference
runs each scanned superblock under ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed_decode as DD
from repro_torch.core import mla as mla_lib
from repro_torch.core.kvcache import (CacheConfig, gqa_append, gqa_prefill, init_gqa_cache,
                                      init_mla_cache, init_paged_mla_cache, mla_append,
                                      mla_prefill, paged_mla_append, paged_mla_prefill,
                                      paged_mla_prefill_at)
from repro_torch.kernels.gqa_decode import ops as gqa_ops
from repro_torch.kernels.gqa_decode import ref as gqa_ref
from repro_torch.kernels.mla_decode import backends as BK
from repro_torch.kernels.mla_decode import ref as mla_kref
from repro_torch.kernels.quantize import fetch_dequant as FD
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib

PORTED_KINDS = ("attn", "swa", "mla", "cross", "dec", "rglru", "mlstm", "slstm")
XLSTM_KINDS = ("mlstm", "slstm")     # self-contained blocks: no MLP
# a cross layer's decode query position: past every slot of its static cache
CROSS_POS = 2**31 - 2                # jnp.iinfo(jnp.int32).max - 1


def _check_aux(cfg: ModelConfig, aux_embed) -> None:
    if aux_embed is None and {"cross", "dec"} & set(cfg.layer_pattern):
        raise ValueError(f"{cfg.name}: cross-attention layers need aux_embed "
                         f"[B, {cfg.n_aux_tokens}, {cfg.d_model}]")


def _check_ported(cfg: ModelConfig) -> None:
    missing = sorted(set(cfg.layer_pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(f"{cfg.name}: layer kinds {missing} are not ported "
                                  f"(ported: {PORTED_KINDS})")
    if "mla" in cfg.layer_pattern and cfg.mla is None:
        raise ValueError(f"{cfg.name}: 'mla' layers need cfg.mla")


def _attn_cfg(cfg: ModelConfig, kind: str) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                        rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
                        window=cfg.window if kind == "swa" else 0, use_rope=True)


def _mla_cfg(cfg: ModelConfig) -> mla_lib.MLAConfig:
    m = cfg.mla
    return mla_lib.MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                             d_head=cfg.d_head, d_rope=m.d_rope, d_c=m.d_c,
                             q_lora_rank=m.q_lora_rank, rope_theta=cfg.rope_theta)


def _cache_cfg(cfg: ModelConfig, kind: str = "mla") -> CacheConfig:
    # the window arms on 'swa' layers only; the sink guard only on
    # contiguous MLA caches (transformer.py:64-70)
    return CacheConfig(fmt=cfg.kv_fmt, page_size=cfg.page_size,
                       window=cfg.window if kind == "swa" else 0,
                       sink_tokens=0 if kind != "mla" or cfg.kv_paged
                       else cfg.kv_sink_tokens)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype, device):
    if kind == "mla":
        mixer = mla_lib.init_mla_params(gen, _mla_cfg(cfg), dtype, device)
    elif kind == "rglru":
        mixer = rglru_lib.init_rglru_params(gen, cfg.d_model, cfg.d_model, dtype, device)
    elif kind == "mlstm":
        mixer = xlstm_lib.init_mlstm_params(gen, cfg.d_model, cfg.n_heads, cfg.d_head, dtype,
                                            device)
    elif kind == "slstm":
        mixer = xlstm_lib.init_slstm_params(gen, cfg.d_model, cfg.n_heads, cfg.d_head, dtype,
                                            device)
    else:
        mixer = L.init_attn_params(gen, _attn_cfg(cfg, kind), dtype, device)
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device), "mixer": mixer}
    if kind == "cross":
        # tanh-gated (llama-vision): zero at init, so a fresh cross layer adds
        # nothing (transformer.py:85-87)
        p["xgate"] = torch.zeros((1,), dtype=dtype, device=device)
    elif kind == "dec":
        p["ln_cross"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["cross"] = L.init_attn_params(gen, _attn_cfg(cfg, kind), dtype, device)
    if cfg.has_mlp and kind not in XLSTM_KINDS:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        # every MLP is MoE when cfg.moe is set: the reference hands each layer
        # first_k_dense itself as its index hint (transformer.py:103-108, :126)
        if cfg.moe is not None:
            p["mlp"] = moe_lib.init_moe_params(gen, cfg.d_model, cfg.moe, dtype, device)
        else:
            p["mlp"] = L.init_mlp_params(gen, cfg.d_model, cfg.d_ff, True, dtype, device)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict[str, Any]:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``)."""
    _check_ported(cfg)
    layers = [_init_layer(gen, cfg, kind, dtype, device) for kind in cfg.layer_kinds]
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    if cfg.encoder_layers:
        # dense 'attn' layers (transformer.py:139-144)
        enc_cfg = dataclasses.replace(cfg, moe=None)
        params["encoder"] = [_init_layer(gen, enc_cfg, "attn", dtype, device)
                             for _ in range(cfg.encoder_layers)]
        params["enc_ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return params


def _init_layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    if kind == "rglru":
        return rglru_lib.init_rglru_state(batch, cfg.d_model, device)
    if kind == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg.n_heads, cfg.d_head, device)
    if kind == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg.n_heads, cfg.d_head, device)
    ccfg = _cache_cfg(cfg, kind)
    if kind in ("attn", "swa"):
        return init_gqa_cache(ccfg, batch, max_len, cfg.n_kv_heads, cfg.d_head,
                              device=device)
    if kind in ("cross", "dec"):
        # the static cross cache: n_aux_tokens rounded up to the page
        # (transformer.py:273-283)
        cross = init_gqa_cache(ccfg, batch, max(cfg.n_aux_tokens, 1), cfg.n_kv_heads,
                               cfg.d_head, device=device)
        if kind == "cross":
            return cross
        return {"self": init_gqa_cache(ccfg, batch, max_len, cfg.n_kv_heads, cfg.d_head,
                                       device=device), "cross": cross}
    dims = (cfg.mla.d_c, cfg.mla.d_rope)
    if cfg.kv_paged:
        # kv_pool_pages > 0: the engine's shared pool (transformer.py:266-270)
        return init_paged_mla_cache(ccfg, batch, max_len, *dims, device=device,
                                    n_pages=cfg.kv_pool_pages)
    return init_mla_cache(ccfg, batch, max_len, *dims, device=device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict[str, Any]:
    _check_ported(cfg)
    return {"layers": [_init_layer_state(cfg, kind, batch, max_len, device)
                       for kind in cfg.layer_kinds],
            "aux": None}     # the encoder output / image embeddings, set by prefill


def _apply_mlp(p, cfg: ModelConfig, x: torch.Tensor):
    """The residual MLP (transformer.py:152-160): (x, dropped fraction) — a
    0-d tensor for a MoE layer, 0.0 for a dense one."""
    if "mlp" not in p:
        return x, 0.0
    h = L.rms_norm(x, p["ln2"])
    if isinstance(p["mlp"], moe_lib.MoEParams):
        out, dropped = moe_lib.moe_layer(p["mlp"], cfg.moe, h, cfg.act)
        return x + out, dropped
    return x + L.mlp(p["mlp"], h, cfg.act), 0.0


def _table(params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """Unembedding of the final normed hidden state: [B, V] f32."""
    x = L.rms_norm(x, params["ln_f"])
    return L.einsum("bd,vd->bv", x.float(), _table(params).float())


# The mesh context of the distributed decode path (transformer.py:315-319),
# set by ``serve --backend shard-map``: {"mesh": DeviceMesh, "dp": the data
# axis name, a tuple of names or None, "use_shard_map": bool}. None: no mesh.
SHARD_CTX = None


def _wsc(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's layout hint (transformer.py:322-335): under
    ``SHARD_CTX``, a DTensor ``x`` is redistributed to ``spec`` ("dp" the
    context's data axes, "model" dropped where it does not divide the
    dimension). It changes no value; a plain tensor, or no context, passes
    unchanged."""
    ctx = SHARD_CTX
    if ctx is None or type(x).__name__ != "DTensor":
        return x
    from repro_torch.launch.mesh import model_axis_size
    from repro_torch.launch.sharding import P, placements_for
    mesh, parts = ctx["mesh"], []
    for p_, dim in zip(spec, x.shape):
        if p_ == "model" and dim % model_axis_size(mesh):
            p_ = None
        elif p_ == "dp":
            p_ = ctx["dp"]
        parts.append(p_)
    pl = placements_for(P(*parts), mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def _resolve_backend(cfg: ModelConfig, batch: int) -> BK.DecodeBackend:
    """The MLA layers' decode backend under ``SHARD_CTX`` (transformer.py:391-397)."""
    ctx = SHARD_CTX
    return BK.resolve_backend(cfg.decode_backend, paged=cfg.kv_paged, batch=batch,
                              n_heads=cfg.n_heads, mesh=ctx["mesh"] if ctx else None,
                              dp=ctx["dp"] if ctx else None, use_kernels=cfg.use_kernels,
                              prefer_shard_map=bool(ctx and ctx.get("use_shard_map")))


def _use_gqa_kernel(cfg: ModelConfig, batch: int) -> bool:
    """GQA layers take the kernel where the MLA layers' backend rule picks a
    kernel backend (``decode_backend`` / ``use_kernels``)."""
    return _resolve_backend(cfg, batch).kind == "kernel"


def _attn_decode(p: L.AttnParams, cfg: ModelConfig, kind: str, x_t: torch.Tensor,
                 cache, pos: torch.Tensor, active: torch.Tensor | None = None):
    """One-token GQA / SWA decode against a quantized cache
    (transformer.py:337-357). ``active`` [B] bool gates the cache append per
    row; inactive rows keep a frozen cache and give finite outputs nobody
    reads."""
    acfg = _attn_cfg(cfg, kind)
    ccfg = _cache_cfg(cfg, kind)
    q, k, v = L.project_qkv(p, acfg, x_t[:, None, :], pos[:, None])
    if active is not None:
        q = torch.where(active[:, None, None, None], q, 0.0)
    cache = gqa_append(cache, ccfg, k[:, 0], v[:, 0], active=active)
    qd = _wsc(q[:, 0].float(), "dp", "model", None)
    o = _wsc(_gqa_attend(cfg, qd, cache, pos, acfg.window, ccfg), "dp", "model", None)
    return L.einsum("bhk,hkd->bd", o.to(x_t.dtype), p.wo), cache


def _gqa_attend(cfg: ModelConfig, q: torch.Tensor, cache, pos: torch.Tensor, window: int,
                ccfg: CacheConfig) -> torch.Tensor:
    """q [B, H, dh] over a ``GQACache`` -> o [B, H, dh] f32: #7 on a kernel
    backend (its plain version on CPU tensors), the parallel form under
    ``ref``."""
    kw = dict(window=window, block_n=ccfg.page_size,
              fmt=ccfg.fmt if ccfg.quantized else "none")
    if _use_gqa_kernel(cfg, q.shape[0]):
        return gqa_ops.gqa_decode(q.float(), cache, pos, **kw)
    return gqa_ref.gqa_decode_parallel_ref(q.float(), cache.k, cache.v, cache.k_scale,
                                           cache.v_scale, cache.slot_pos, pos, **kw)


def _cross_decode(p: L.AttnParams, cfg: ModelConfig, x_t: torch.Tensor, cache):
    """One-token cross attention against the static quantized aux cache
    (transformer.py:360-371): no RoPE, every filled slot valid (the query
    sits at ``CROSS_POS``, past every slot), the cache never written."""
    q = L.einsum("bd,dhk->bhk", x_t, p.wq)
    if p.bq is not None:
        q = q + p.bq
    pos = torch.full((x_t.shape[0],), CROSS_POS, dtype=torch.int32, device=x_t.device)
    o = _gqa_attend(cfg, q, cache, pos, 0, _cache_cfg(cfg, "attn"))
    return L.einsum("bhk,hkd->bd", o.to(x_t.dtype), p.wo)


def _xgate(p, x: torch.Tensor) -> torch.Tensor:
    """A ``cross`` layer's gate tanh(xgate), in float32, cast to x's dtype."""
    return torch.tanh(p["xgate"].float()).to(x.dtype)


def _mla_decode(p: mla_lib.MLAParams, cfg: ModelConfig, x_t: torch.Tensor, cache,
                pos: torch.Tensor, active: torch.Tensor | None = None):
    """SnapMLA decode: cache append + Fused-Q-Quant + backend attention.

    The reference runs ``prepare_q`` here (transformer.py:421); on a kernel
    backend the port hands the raw query to the decode kernel, whose
    prologue runs Fused-Q-Quant (``_prepare_query``). On the ``shard_map``
    backend the contiguous cache appends through the collective-free region
    too (transformer.py:400-409). ``_wsc`` places the latent query and
    output as the reference's layout hints do (a no-op off a DTensor
    step)."""
    mcfg = _mla_cfg(cfg)
    ccfg = _cache_cfg(cfg)
    ctx = SHARD_CTX
    backend = _resolve_backend(cfg, x_t.shape[0])
    c_kv, k_r = mla_lib.project_kv(p, mcfg, x_t[:, None, :], pos[:, None])
    if cfg.kv_paged:
        cache = paged_mla_append(cache, ccfg, c_kv[:, 0], k_r[:, 0], active=active)
    elif backend.name == "shard_map":
        # ``active`` is a batch-dim mask: it shards over dp into the region
        sharded = DD.mla_append_shard_map(ctx["mesh"], ctx["dp"], cache, ccfg, c_kv[:, 0],
                                          k_r[:, 0], active=active)
        cache = DD.appended(cache, sharded)
    else:
        cache = mla_append(cache, ccfg, c_kv[:, 0], k_r[:, 0], active=active)
    q_c, q_r = mla_lib.project_q(p, mcfg, x_t[:, None, :], pos[:, None])
    if active is not None:
        # finished rows: zero the query (EPS keeps the scale finite)
        q_c = torch.where(active[:, None, None, None], q_c, 0.0)
        q_r = torch.where(active[:, None, None, None], q_r, 0.0)
    q_lat = _wsc(mla_lib.absorb_q(p, q_c[:, 0]), "dp", "model", None)
    o_lat = backend.decode(_prepare_query(q_lat, q_r[:, 0], ccfg, backend),
                           cache, _backend_cfg(cfg, mcfg, ccfg),
                           {"mesh": ctx["mesh"], "dp": ctx["dp"]} if ctx else None)
    o_lat = _wsc(o_lat, "dp", "model", None)
    return mla_lib.output_proj(p, o_lat.to(x_t.dtype)), cache


def _prepare_query(q_lat: torch.Tensor, q_r: torch.Tensor, ccfg: CacheConfig,
                   backend: BK.DecodeBackend) -> BK.DecodeQuery:
    """The [B, (K,) H, .] decode query: raw on a kernel backend over an fp8 /
    int8 cache (the decode kernel runs Fused-Q-Quant, kernel D, in its
    prologue; on CPU tensors its plain version), ``prepare_q`` otherwise —
    the same function (quantize/ref.py and ref.py:528-537 both call
    ``quantize_rope_aware``)."""
    fmt = ccfg.fmt if ccfg.quantized else "none"
    if fmt != "none" and backend.kind == "kernel":
        return BK.DecodeQuery.raw(q_lat.float(), q_r.float())
    return BK.DecodeQuery(*mla_kref.prepare_q(q_lat, q_r, fmt))


def _backend_cfg(cfg: ModelConfig, mcfg, ccfg: CacheConfig) -> BK.BackendConfig:
    return BK.BackendConfig(softmax_scale=mcfg.softmax_scale,
                            block_n=cfg.kv_block_n or ccfg.page_size,
                            fmt=ccfg.fmt if ccfg.quantized else "none",
                            num_splits=cfg.kv_splits, rescale=cfg.kv_rescale)


_STEPS = {"rglru": rglru_lib.rglru_step, "mlstm": xlstm_lib.mlstm_step,
          "slstm": xlstm_lib.slstm_step}
# prefill / training: each recurrent block from a fresh state (the reference
# passes none, transformer.py:593-601)
_BLOCKS = {"rglru": rglru_lib.rglru_block, "mlstm": xlstm_lib.mlstm_block,
           "slstm": xlstm_lib.slstm_block}


def _freeze_inactive(active: torch.Tensor, new, old):
    """Per-row recurrent-state freeze (transformer.py:434-441): the rows
    where ``active`` is False keep ``old``."""
    return type(new)(*(torch.where(active.reshape(active.shape + (1,) * (n.dim() - 1)), n, o)
                       for n, o in zip(new, old)))


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state,
                pos: torch.Tensor, active: torch.Tensor | None = None):
    """token [B] int, pos [B] int -> (logits [B, V] f32, new state).

    ``active`` [B] bool (optional) marks rows still generating: inactive rows
    skip their cache append and run with zeroed queries."""
    _check_ported(cfg)
    x_t = L.embed(params["embed"], token)
    new_layers = []
    for p, kind, cache in zip(params["layers"], cfg.layer_kinds, state["layers"]):
        h = L.rms_norm(x_t, p["ln1"])
        if kind == "mla":
            y, cache = _mla_decode(p["mixer"], cfg, h, cache, pos, active)
        elif kind in _STEPS:
            y, new = _STEPS[kind](p["mixer"], h, cache)
            cache = new if active is None else _freeze_inactive(active, new, cache)
        elif kind == "cross":
            y = _xgate(p, x_t) * _cross_decode(p["mixer"], cfg, h, cache)
        elif kind == "dec":
            y, self_c = _attn_decode(p["mixer"], cfg, "attn", h, cache["self"], pos, active)
            x_t = x_t + y
            y = _cross_decode(p["cross"], cfg, L.rms_norm(x_t, p["ln_cross"]), cache["cross"])
            cache = {"self": self_c, "cross": cache["cross"]}
        else:
            y, cache = _attn_decode(p["mixer"], cfg, kind, h, cache, pos, active)
        x_t, _ = _apply_mlp(p, cfg, x_t + y)
        new_layers.append(cache)
    return _logits(params, x_t), {**state, "layers": new_layers}


def _apply_block_train(p, cfg: ModelConfig, kind: str, x: torch.Tensor,
                       positions: torch.Tensor, aux: torch.Tensor | None):
    """One layer of the training forward (transformer.py:164-187): (x, the
    layer's MoE dropped fraction)."""
    h = L.rms_norm(x, p["ln1"])
    if kind == "mla":
        x = x + mla_lib.mla_attention(p["mixer"], _mla_cfg(cfg), h, positions)
    elif kind in _BLOCKS:
        x = x + _BLOCKS[kind](p["mixer"], h)[0]
    elif kind == "cross":
        x = x + _xgate(p, x) * L.cross_attention_block(p["mixer"], _attn_cfg(cfg, kind), h, aux)
    elif kind == "dec":
        acfg = _attn_cfg(cfg, kind)
        x = x + L.attention_block(p["mixer"], acfg, h, positions)
        x = x + L.cross_attention_block(p["cross"], acfg, L.rms_norm(x, p["ln_cross"]), aux)
    else:
        x = x + L.attention_block(p["mixer"], _attn_cfg(cfg, kind), h, positions)
    return _apply_mlp(p, cfg, x)


def _run_encoder(params, cfg: ModelConfig, aux_embed: torch.Tensor | None):
    """Whisper's bidirectional encoder over the frame embeddings
    (transformer.py:190-205); ``aux_embed`` itself for a model without one."""
    if cfg.encoder_layers == 0 or aux_embed is None:
        return aux_embed
    positions = torch.arange(aux_embed.shape[1], device=aux_embed.device)
    enc_cfg = dataclasses.replace(cfg, moe=None)
    acfg = _attn_cfg(enc_cfg, "attn")
    x = aux_embed
    for p in params["encoder"]:
        x = x + L.attention_block(p["mixer"], acfg, L.rms_norm(x, p["ln1"]), positions,
                                  causal=False)
        x, _ = _apply_mlp(p, enc_cfg, x)
    return L.rms_norm(x, params["enc_ln_f"])


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            aux_embed: torch.Tensor | None = None, remat: bool = True):
    """Training forward (transformer.py:208): tokens [B, S] (and the encoder
    families' ``aux_embed`` [B, n_aux_tokens, d]) -> (logits [B, S, V] f32,
    the MoE auxiliary: the dropped fractions summed over the layers, 0.0 for
    a dense model). With ``remat`` and autograd recording, each full
    superblock (``pattern_len`` layers) runs under ``torch.utils.checkpoint``
    and is recomputed in the backward pass, as the reference's scanned
    superblocks are under ``jax.checkpoint``; the remainder layers are not.
    The numbers do not depend on ``remat``."""
    _check_ported(cfg)
    _check_aux(cfg, aux_embed)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = _run_encoder(params, cfg, aux_embed)
    kinds, layers = cfg.layer_kinds, params["layers"]

    def superblock(x, lo, hi):
        dropped = 0.0
        for p, kind in zip(layers[lo:hi], kinds[lo:hi]):
            x, d = _apply_block_train(p, cfg, kind, x, positions, aux)
            dropped = dropped + d
        return x, dropped

    checkpointed = remat and torch.is_grad_enabled()
    n, total = cfg.pattern_len, 0.0
    for lo in range(0, cfg.n_superblocks * n, n):
        if checkpointed:
            x, d = torch.utils.checkpoint.checkpoint(superblock, x, lo, lo + n,
                                                     use_reentrant=False)
        else:
            x, d = superblock(x, lo, lo + n)
        total = total + d
    x, d = superblock(x, cfg.n_superblocks * n, len(kinds))
    total = total + d
    return L.unembed(_table(params), L.rms_norm(x, params["ln_f"])), total


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
            aux_embed: torch.Tensor | None = None, remat: bool = True):
    """Next-token cross entropy over the labels ``>= 0`` (labels == -1 are
    masked; transformer.py:244-253) -> (loss, {"ce": loss, "moe_dropped"})."""
    logits, aux = forward(params, cfg, tokens, aux_embed, remat)
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return loss, {"ce": loss, "moe_dropped": aux}


def _prefill_layer(p, cfg: ModelConfig, kind: str, x: torch.Tensor, cache,
                   positions: torch.Tensor, aux: torch.Tensor | None):
    """One layer over the prompt: its output and its filled cache
    (transformer.py:537-578)."""
    h = L.rms_norm(x, p["ln1"])
    if kind == "mla":
        mcfg = _mla_cfg(cfg)
        x = x + mla_lib.mla_attention(p["mixer"], mcfg, h, positions)
        c_kv, k_r = mla_lib.project_kv(p["mixer"], mcfg, h, positions)
        fill = paged_mla_prefill if cfg.kv_paged else mla_prefill
        cache = fill(cache, _cache_cfg(cfg), c_kv, k_r)
    elif kind in _BLOCKS:
        y, cache = _BLOCKS[kind](p["mixer"], h)
        x = x + y
    elif kind == "cross":
        x = x + _xgate(p, x) * L.cross_attention_block(p["mixer"], _attn_cfg(cfg, kind), h, aux)
        cache = _fill_cross_cache(p["mixer"], cfg, aux, cache)
    else:
        acfg = _attn_cfg(cfg, kind)
        q, k, v = L.project_qkv(p["mixer"], acfg, h, positions)
        o = L.flash_sdpa(q, k, v, causal=True, window=acfg.window)
        self_c = gqa_prefill(cache["self"] if kind == "dec" else cache,
                             _cache_cfg(cfg, kind), k, v)
        x = x + L.einsum("bshk,hkd->bsd", o, p["mixer"].wo)
        if kind == "dec":
            x = x + L.cross_attention_block(p["cross"], acfg, L.rms_norm(x, p["ln_cross"]),
                                            aux)
            cache = {"self": self_c,
                     "cross": _fill_cross_cache(p["cross"], cfg, aux, cache["cross"])}
        else:
            cache = self_c
    return _apply_mlp(p, cfg, x)[0], cache


def _fill_cross_cache(attn_p: L.AttnParams, cfg: ModelConfig, aux: torch.Tensor, cache):
    """Project the aux rows into a cross layer's K / V and quantize them into
    its static cache, in place (transformer.py:581-586)."""
    k = L.einsum("bsd,dhk->bshk", aux, attn_p.wk)
    v = L.einsum("bsd,dhk->bshk", aux, attn_p.wv)
    if attn_p.bk is not None:
        k, v = k + attn_p.bk, v + attn_p.bv
    return gqa_prefill(cache, _cache_cfg(cfg, "attn"), k, v)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, state,
            aux_embed: torch.Tensor | None = None):
    """tokens [B, S] (and ``aux_embed`` for the encoder families) -> (last
    token logits [B, V], filled decode state, ``state["aux"]`` the encoder
    output)."""
    _check_ported(cfg)
    _check_aux(cfg, aux_embed)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = _run_encoder(params, cfg, aux_embed)
    new_layers = []
    for p, kind, cache in zip(params["layers"], cfg.layer_kinds, state["layers"]):
        x, cache = _prefill_layer(p, cfg, kind, x, cache, positions, aux)
        new_layers.append(cache)
    return _logits(params, x[:, -1]), {**state, "layers": new_layers, "aux": aux}


def _check_paged_mla(cfg: ModelConfig, what: str) -> None:
    if cfg.layer_pattern != ("mla",) or cfg.mla is None:
        raise NotImplementedError(f"{what} drives the paged MLA pipeline; {cfg.name}'s "
                                  f"layer pattern {cfg.layer_pattern} is not pure-MLA")
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
    return _apply_mlp(p, cfg, x)[0], pool


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
    return _apply_mlp(p, cfg, x)[0], pool


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
    logits = L.einsum("bkd,vd->bkv", x.float(), _table(params).float())
    return logits, {**state, "layers": new_layers}
