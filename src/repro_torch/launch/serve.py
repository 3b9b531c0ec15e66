"""Serving launcher of the port: batched prefill + per-step decode against the
FP8 latent cache — the contiguous per-slot cache by default, the paged pool
with ``--paged`` (port of the step-loop path of ``repro/launch/serve.py``).

On the card, with the hand-written kernels:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mla-7b --backend kernel --batch 4 --prompt-len 512 --gen 16

(add ``--paged``, ``--kv-splits N``, ``--rescale amla``, ``--sink-tokens K`` or
``--block-n N``). On the CPU (plain PyTorch versions of every kernel):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mla-7b --smoke --backend kernel --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.kvcache import page_aligned_capacity
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


def _check_finite(ok: torch.Tensor, where: str) -> None:
    """Loud NaN gate: ``ok`` is raw logits or an already-reduced flag."""
    if not bool(torch.all(torch.isfinite(ok)) if ok.dtype != torch.bool else ok):
        raise SystemExit(f"[serve] FATAL: non-finite logits at {where}")


def _decode_capacity(cfg, prompt_len: int, gen_steps: int) -> int:
    """Page-aligned cache capacity for prompt + generation."""
    return page_aligned_capacity(prompt_len + gen_steps, cfg.page_size)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: torch.Tensor, gen_steps: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_id: int | None = None, seed: int = 0, return_logits: bool = False):
    """prompts [B, S] (on the params' device) -> (generated tokens
    [B, gen_steps], decode tok/s) — plus the logits of every step
    [B, gen_steps, V] when ``return_logits``.

    Per-step decode loop; sampling draws from one ``torch.Generator`` seeded
    with ``seed``; ``eos_id`` stops the loop once every sequence emitted it
    (finished sequences are padded with ``eos_id``). tok/s counts the decode
    steps after the first (which is the warm-up)."""
    device = prompts.device
    B, S = prompts.shape
    max_len = _decode_capacity(cfg, S, gen_steps)
    prefill_fn = ST.make_prefill_step(cfg)
    decode_fn = ST.make_decode_step(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def pick(logits):
        return ST.sample_logits(logits, gen, temperature, top_k, top_p)

    state = T.init_decode_state(cfg, B, max_len, device=device)
    logits, state = prefill_fn(params, prompts, state)
    _check_finite(logits, "prefill")
    all_logits = [logits]
    tok = pick(logits)
    done = (tok == eos_id) if eos_id is not None \
        else torch.zeros((B,), dtype=torch.bool, device=device)

    outs = [tok]

    def finish(tps):
        toks = torch.stack(outs, dim=1)[:, :gen_steps]
        if return_logits:
            return toks, tps, torch.stack(all_logits, dim=1)[:, :gen_steps]
        return toks, tps

    if gen_steps <= 1:
        return finish(0.0)
    pos = torch.full((B,), S, dtype=torch.int32, device=device)
    logits, state = decode_fn(params, tok, state, pos)   # warm-up step
    ok = torch.all(torch.isfinite(logits))
    all_logits.append(logits)
    tok, done = ST.apply_eos(pick(logits), done, eos_id)
    outs.append(tok)
    _sync(device)

    steps_run = 0
    t0 = time.perf_counter()
    for i in range(1, gen_steps - 1):
        if eos_id is not None and bool(torch.all(done)):
            break               # EOS early stop: every sequence finished
        pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
        logits, state = decode_fn(params, tok, state, pos)
        ok = ok & torch.all(torch.isfinite(logits))
        all_logits.append(logits)
        tok, done = ST.apply_eos(pick(logits), done, eos_id)
        outs.append(tok)
        steps_run += 1
    _sync(device)
    dt = time.perf_counter() - t0
    _check_finite(ok, "decode (any step)")
    while len(outs) < gen_steps:    # EOS-stopped early: pad to [B, gen_steps]
        outs.append(torch.full((B,), eos_id, dtype=torch.int32, device=device))
    return finish(B * steps_run / max(dt, 1e-9) if steps_run else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mla-7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fmt", default="fp8_e4m3", choices=["fp8_e4m3", "int8", "none"])
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool for the MLA layers (latent entries in a "
                         "page pool addressed through per-sequence page tables) "
                         "instead of the contiguous per-slot cache")
    ap.add_argument("--backend", default="auto", choices=["auto", "ref", "kernel"],
                    help="decode attention: 'ref' = plain PyTorch, 'kernel' = the "
                         "hand-written Hopper kernels (plain versions on CPU), "
                         "'auto' = ref")
    ap.add_argument("--kv-splits", type=int, default=0,
                    help="split-KV splits, contiguous and paged caches "
                         "(0 = context-length heuristic, 1 = single pass)")
    ap.add_argument("--block-n", type=int, default=0,
                    help="decode KV block size (0 = page size). Contiguous caches "
                         "take any divisor of the capacity the kernels support; "
                         "with --paged the block is the page, so this sets the "
                         "page size itself")
    ap.add_argument("--sink-tokens", type=int, default=0,
                    help="P-Cast sink guard: keep the first k tokens' latent rows "
                         "in full precision (contiguous caches only; 0 = off)")
    ap.add_argument("--rescale", default="fma", choices=["fma", "amla"],
                    help="per-block accumulator rescale of the decode kernels: "
                         "fma = exact max-shift FMA, amla = exponent-add on the "
                         "power-of-two grid with combine-free split partials")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and sampling")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--engine", action="store_true", help="not ported yet")
    ap.add_argument("--fused", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    if args.engine or args.fused:
        ap.error("--engine / --fused are not ported yet")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, kv_fmt=args.fmt, kv_splits=args.kv_splits,
                              kv_paged=args.paged, kv_rescale=args.rescale,
                              kv_sink_tokens=args.sink_tokens,
                              decode_backend=args.backend,
                              use_kernels=args.backend == "kernel")
    if args.block_n:
        # a paged pool's decode block IS its page, so --block-n repages it;
        # a contiguous cache keeps its page size and overrides the block
        cfg = dataclasses.replace(cfg, page_size=args.block_n) if args.paged \
            else dataclasses.replace(cfg, kv_block_n=args.block_n)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_model(gen, cfg, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int64)
    sample_kw = dict(temperature=args.temperature, top_k=args.top_k,
                     top_p=args.top_p, eos_id=args.eos_id, seed=args.seed)
    toks, tps = generate(cfg, params, prompts, args.gen, **sample_kw)
    cache_kind = "paged" if args.paged else "contiguous"
    print(f"[serve] {cfg.name} fmt={args.fmt} backend={args.backend} "
          f"rescale={args.rescale} (step-loop, {cache_kind} cache, {device}): "
          f"generated {tuple(toks.shape)} at {tps:.1f} tok/s (decode)")
    if args.fmt != "none":
        cfg_b = dataclasses.replace(cfg, kv_fmt="none")
        toks_b, _ = generate(cfg_b, params, prompts, args.gen, **sample_kw)
        agree = float(torch.mean((toks == toks_b).float()))
        print(f"[serve] token agreement vs BF16 pipeline: {agree * 100:.1f}%")


if __name__ == "__main__":
    main()
