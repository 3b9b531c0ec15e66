"""Deterministic synthetic LM data, host-shardable and resumable (port of
``repro/data/pipeline.py``).

A batch is a pure function of (seed, step), so any host can reproduce any
step and the pipeline's cursor is the step counter in the checkpoint
manifest. The token stream mixes Zipf-distributed unigrams with rows whose
second half repeats the first (next-token structure a model can learn), and
the encoder families get random frame / patch embeddings.

Counter-based draws: each step's batch comes from one ``torch.Generator``
seeded from (seed, step), on the CPU. The draws are not the reference's
(``jax.random`` threefry bits): the same (seed, step) gives the same batch
in the port, and a different one from the reference's."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_aux_tokens: int = 0        # emit stub modality embeddings if > 0
    d_model: int = 0


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's batch, seeded from (seed, step)."""
    key = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def synth_batch(cfg: DataConfig, step: int) -> dict[str, torch.Tensor]:
    """The global batch of ``step`` on the CPU: ``tokens`` and ``labels``
    [global_batch, seq_len] int32 (labels = tokens shifted by one), and
    ``aux_embed`` [global_batch, n_aux_tokens, d_model] float32 when
    ``n_aux_tokens > 0``."""
    gen = step_generator(cfg.seed, int(step))
    B, S = cfg.global_batch, cfg.seq_len
    zipf = 1.0 / torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    base = torch.multinomial(zipf, B * (S + 1), replacement=True,
                             generator=gen).view(B, S + 1)
    # copy structure: the second half repeats the first half
    half = (S + 1) // 2
    rep = torch.cat([base[:, :half], base[:, :S + 1 - half]], dim=1)
    use_rep = torch.rand((B, 1), generator=gen) < 0.5
    seq = torch.where(use_rep, rep, base).to(torch.int32)
    out = {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}
    if cfg.n_aux_tokens:
        out["aux_embed"] = torch.randn((B, cfg.n_aux_tokens, cfg.d_model), generator=gen)
    return out


def host_slice(cfg: DataConfig, step: int, host_id: int, n_hosts: int):
    """The shard of the global batch host ``host_id`` of ``n_hosts`` reads."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split over "
                         f"{n_hosts} hosts")
    per = cfg.global_batch // n_hosts
    return {k: v[host_id * per:(host_id + 1) * per] for k, v in synth_batch(cfg, step).items()}


def batch_iterator(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
                   n_hosts: int = 1):
    """Resumable iterator of (step, batch) pairs from ``start_step``."""
    step = start_step
    while True:
        yield step, host_slice(cfg, step, host_id, n_hosts)
        step += 1
