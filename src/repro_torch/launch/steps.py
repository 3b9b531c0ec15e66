"""Prefill / decode / chunked-prefill / verify steps and sampling (port of
the serving half of ``repro/launch/steps.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, state):
        return T.prefill(params, cfg, tokens, state)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, state, pos):
        return T.decode_step(params, cfg, token, state, pos)

    return decode_step


def make_ref_decode_step(cfg: ModelConfig):
    """Decode step pinned to the plain reference backend: the serving
    engine's degradation twin (quarantine retry, fallback of a raising
    dispatch)."""
    ref_cfg = dataclasses.replace(cfg, decode_backend="ref", use_kernels=False)

    def ref_decode_step(params, token, state, pos):
        return T.decode_step(params, ref_cfg, token, state, pos)

    return ref_decode_step


def make_verify_step(cfg: ModelConfig, ref: bool = False):
    """verify_step(params, tokens [B, K], state, start [B]) -> (logits
    [B, K, V], state); ``ref=True`` pins the plain reference backend."""
    vcfg = dataclasses.replace(cfg, decode_backend="ref", use_kernels=False) if ref else cfg

    def verify_step(params, tokens, state, start):
        return T.verify_step(params, vcfg, tokens, state, start)

    return verify_step


def make_chunked_prefill_step(cfg: ModelConfig):
    """chunk_prefill_step(params, tokens [B, C], state, chunk_start [B],
    last_idx [B]) -> (logits [B, V] at the last real token, state)."""
    def chunk_prefill_step(params, tokens, state, chunk_start, last_idx):
        return T.chunked_prefill(params, cfg, tokens, state, chunk_start, last_idx)

    return chunk_prefill_step


def chunk_buckets(prefill_chunk: int) -> list[int]:
    """Chunk widths: powers of two below ``prefill_chunk``, then
    ``prefill_chunk`` itself. The engine pads every chunk up to its bucket,
    so it dispatches at most ``len(buckets)`` distinct chunk widths."""
    if prefill_chunk < 1:
        raise ValueError("prefill_chunk must be >= 1 to bucket")
    buckets = []
    b = 1
    while b < prefill_chunk:
        buckets.append(b)
        b *= 2
    buckets.append(prefill_chunk)
    return buckets


def bucket_for(n_tokens: int, prefill_chunk: int) -> int:
    """Smallest bucket covering ``n_tokens`` (the padded chunk width)."""
    for b in chunk_buckets(prefill_chunk):
        if b >= n_tokens:
            return b
    raise ValueError(f"{n_tokens} tokens exceed prefill_chunk {prefill_chunk}")


def masked_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The temperature-scaled logits ``sample_logits`` draws from: top-k, then
    nucleus (top-p) truncation, dropped entries set to -inf."""
    scaled = logits.float() / temperature
    if 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if 0.0 < top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep while the mass BEFORE a token is < top_p: the first token is
        # always kept, and the token that crosses the threshold is included
        keep = (cum - probs) < top_p
        cutoff = torch.amin(torch.where(keep, desc, float("inf")), dim=-1,
                            keepdim=True)
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    return scaled


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Next-token selection from [B, V] logits: ``temperature <= 0`` is greedy
    argmax (generator unused), otherwise a categorical draw from
    ``masked_logits`` with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(masked_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def apply_eos(tok: torch.Tensor, done: torch.Tensor, eos_id: int | None):
    """Pin sequences that already finished to ``eos_id``, then fold this
    step's emissions into the done mask. No-op when ``eos_id`` is None."""
    if eos_id is None:
        return tok, done
    tok = torch.where(done, torch.full_like(tok, eos_id), tok)
    return tok, done | (tok == eos_id)
