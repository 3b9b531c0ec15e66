"""Serving launcher of the port: batched prefill + per-step decode against the
FP8 latent cache — the contiguous per-slot cache by default, the paged pool
with ``--paged`` — with ``--fused``, the whole decode as one decode step
captured once as a CUDA graph and replayed per token (``generate_fused``;
eager on the CPU), and, with ``--engine``, the continuous-batching serving
engine over the shared paged pool (port of ``repro/launch/serve.py``).

On the card, with the hand-written kernels:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mla-7b --backend kernel --batch 4 --prompt-len 512 --gen 16

(add ``--paged``, ``--kv-splits N``, ``--rescale amla``, ``--sink-tokens K`` or
``--block-n N``; ``--fused`` for the captured loop; ``--arch deepseek-v3-mla`` serves the MLA MoE model with
q-LoRA through the same MLA kernels; ``--arch llama3.2-3b``, ``qwen2.5-3b``,
``gemma3-27b``, ``granite-3-2b``, ``qwen3-moe-30b-a3b`` or ``mixtral-8x7b``
serve the GQA family, dense and MoE, through the FP8 GQA decode kernel, where
the MLA-only flags do nothing; ``--arch recurrentgemma-9b`` (RG-LRU layers and
local attention through the same kernel at d_head 256) and ``xlstm-1.3b``
(mLSTM / sLSTM, no KV cache) serve the recurrent families; ``--arch
whisper-base`` (encoder-decoder) and ``llama-3.2-vision-90b`` (gated cross
attention) serve the encoder families on random frame / patch embeddings,
each cross layer through the same kernel over its static cache). On the CPU
(plain PyTorch versions of every kernel):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mla-7b --smoke --backend kernel --device cpu

The engine (staggered arrivals, prefix sharing, chunked prefill, speculative
decoding), gated against the static-batch ``generate`` oracle:

    PYTHONPATH=src python -m repro_torch.launch.serve --engine --backend kernel \
        --batch 4 --max-batch 2 --prompt-lens 1000,130,513,256 \
        --prefill-chunk 256 --prefill-budget 512 --gen 16

(``--spec-draft K`` for self-speculative decoding; ``--prefix-cache-pages N
--host-tier-pages M`` for the radix prefix cache and its pinned host tier;
``--restartable --ckpt-every N --inject preempt:K`` for the snapshot /
restore drill; ``--trace-out t.json`` for the Chrome trace, summarized by
``python -m repro_torch.obs.trace_report t.json``; ``--quant-health-every N``
for the FP8 pool probe; ``--smoke --device cpu`` on the CPU; ``--arch``
mla-7b or deepseek-v3-mla, the pure-MLA models). Under MoE the expert
capacity depends on how many tokens share a call, so the engine's batches
and ``generate``'s static batch can drop different tokens and the oracle
gate can fail, as the reference's does on deepseek-v3-mla. ``--engine
--fused`` exits, as the reference's does.

``--backend shard-map`` decodes each MLA layer's attention (and its cache
append) in the collective-free ``local_map`` region over the host ``("data",
"model")`` mesh (``core/distributed_decode.py``): without a launcher a world
of one in this process (NCCL on the card, gloo on the CPU), under
``torchrun`` every rank, each running the replicated step with the region
batch-sharded and printing the same tokens:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --smoke --backend shard-map --device cpu

``--engine --backend shard-map`` is refused: the engine's pool is paged.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.kvcache import page_aligned_capacity
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
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
             aux_embed: torch.Tensor | None = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0, eos_id: int | None = None, seed: int = 0,
             return_logits: bool = False):
    """prompts [B, S] (on the params' device; the encoder families also take
    ``aux_embed`` [B, n_aux_tokens, d]) -> (generated tokens [B, gen_steps],
    decode tok/s) — plus the logits of every step [B, gen_steps, V] when
    ``return_logits``.

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
    logits, state = prefill_fn(params, prompts, state, aux_embed)
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


def generate_fused(cfg, params, prompts: torch.Tensor, gen_steps: int, *,
                   aux_embed: torch.Tensor | None = None, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 0.0, eos_id: int | None = None,
                   seed: int = 0, return_logits: bool = False, stats: dict | None = None):
    """Prefill, then the whole decode as ``make_fused_decode``: on the card
    one decode step captured once as a CUDA graph and replayed per token
    (serve.py:121-174). Returns what ``generate`` returns: (tokens
    [B, gen_steps], decode tok/s), plus the logits of every step
    [B, gen_steps, V] when ``return_logits``.

    Greedy runs give ``generate``'s tokens; sampling draws from one
    ``torch.Generator`` seeded with ``seed`` in ``generate``'s order;
    ``eos_id`` pins finished rows to ``eos_id`` and freezes their caches.
    tok/s counts the steps after the first decode step over their wall (the
    first step and the capture are timed apart, as ``stats["capture_s"]``,
    as ``generate`` leaves out its warm-up step); ``stats`` (a dict)
    receives ``make_fused_decode``'s."""
    device = prompts.device
    B, S = prompts.shape
    prefill_fn = ST.make_prefill_step(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = T.init_decode_state(cfg, B, _decode_capacity(cfg, S, gen_steps), device=device)
    logits, state = prefill_fn(params, prompts, state, aux_embed)
    _check_finite(logits, "prefill")
    tok = ST.sample_logits(logits, gen, temperature, top_k, top_p)
    if gen_steps <= 1:
        toks = tok[:, None][:, :gen_steps]
        return (toks, 0.0, logits[:, None][:, :gen_steps]) if return_logits else (toks, 0.0)
    fused_fn = ST.make_fused_decode(cfg, gen_steps - 1, temperature=temperature,
                                    top_k=top_k, top_p=top_p, eos_id=eos_id,
                                    return_logits=return_logits)
    info: dict = {}
    out = fused_fn(params, tok, state, torch.full((B,), S, dtype=torch.int32, device=device),
                   generator=gen, stats=info)
    _check_finite(out[2], "fused decode (any step)")
    if stats is not None:
        stats.update(info)
    tps = B * info["steps_timed"] / max(info["decode_s"], 1e-9) if info["steps_timed"] else 0.0
    toks = torch.cat([tok[:, None], out[0]], dim=1)
    if return_logits:
        return toks, tps, torch.cat([logits[:, None], out[3]], dim=1)
    return toks, tps


def _engine_prompts(cfg, args) -> list[np.ndarray]:
    """Per-request prompts for ``--engine``: ``--prompt-lens`` (a comma list
    cycled over ``--batch`` requests) gives a mixed long + short workload,
    otherwise every prompt has ``--prompt-len`` tokens; ``--shared-prefix N``
    makes the first N tokens the same in every request. Drawn from numpy
    generators seeded with (``--seed``, request index)."""
    if args.prompt_lens:
        lens = [int(x) for x in args.prompt_lens.split(",")]
        lens = [lens[i % len(lens)] for i in range(args.batch)]
    else:
        lens = [args.prompt_len] * args.batch
    shared = np.random.default_rng([args.seed, 2**31 - 1]).integers(
        0, cfg.vocab_size, max(args.shared_prefix, 0), dtype=np.int32)
    prompts = []
    for i, n in enumerate(lens):
        p = np.random.default_rng([args.seed, i]).integers(0, cfg.vocab_size, n,
                                                           dtype=np.int32)
        k = min(len(shared), n)
        p[:k] = shared[:k]
        prompts.append(p)
    return prompts


def _make_logger(log_json: bool):
    """The engine's status lines: prose by default, one JSON object per line
    (``{"event": ..., ...}``) with ``--log-json``."""
    def log(event: str, text: str, **fields) -> None:
        if log_json:
            print(json.dumps({"event": event, **fields}, sort_keys=True, default=float))
        else:
            print(text)
    return log


def run_restartable(new_engine, reqs, args, ckpt_dir, on_restart=None):
    """``serve --restartable``'s loop: under ``run_with_restarts`` (at most 3
    restarts) each attempt builds an engine with ``new_engine(handler)`` (a
    ``PreemptionHandler``, its signal handlers installed unless faults are
    injected), restores the latest snapshot under ``ckpt_dir`` and runs
    ``reqs`` with a snapshot every ``args.ckpt_every`` steps; the engine
    skips requests it has already seen. Returns the last attempt's engine
    and its results."""
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.runtime.fault_tolerance import (PreemptionHandler, RestartPolicy,
                                                     run_with_restarts)
    handler = PreemptionHandler(install=not args.inject)
    out: dict = {}

    def attempt() -> str:
        handler.reset()
        engine = new_engine(handler)
        latest = CK.latest_checkpoint(ckpt_dir)
        if latest:
            engine.restore(latest)
        out["engine"] = engine
        out["results"] = engine.run(reqs, ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every)
        return "done"

    try:
        run_with_restarts(attempt, RestartPolicy(max_restarts=3), on_restart=on_restart)
    finally:
        handler.restore()
    return out["engine"], out["results"]


def run_engine(cfg, params, args) -> dict:
    """``serve --engine``: the continuous-batching engine over the shared
    paged pool, with the static-batch ``generate`` as the greedy parity
    oracle (per prompt-length group). Arrivals are staggered every
    ``--arrival-gap`` engine steps; ``--prefill-chunk`` switches admission
    to budgeted chunked prefill. Exits non-zero on a token mismatch (greedy,
    no requeues), leaked pages, more chunk widths than buckets, a fault drill
    with no completed request, or a dispatch that fell back to the reference
    backend without an injected fault.

    Fault drills: ``--inject kind:step[:slot][:sticky]`` threads a
    deterministic ``FaultPlan`` through the engine; ``--restartable`` runs it
    in ``run_restartable``, so a preemption (injected, or SIGTERM / SIGINT)
    snapshots, ends the attempt, and the next attempt restores the latest
    snapshot. Returns ``{"engine", "results", "metrics",
    "prompts", "tracer", "restarts", "ckpt_dir"}``."""
    from repro_torch.obs.trace import SpanTracer, validate_chrome_trace
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.scheduler import Request

    log = _make_logger(args.log_json)
    tracer = SpanTracer(clock=args.trace_clock) if args.trace_out else None
    device = params["embed"].device
    prompts = _engine_prompts(cfg, args)
    span_pages = page_aligned_capacity(max(len(p) for p in prompts) + args.gen,
                                       cfg.page_size) // cfg.page_size
    cfg = dataclasses.replace(cfg, prefill_chunk=args.prefill_chunk)
    ecfg = EngineConfig(
        max_batch=args.max_batch or len(prompts), max_pages_per_seq=span_pages,
        n_pages=args.pool_pages, prefix_sharing=not args.no_prefix_share,
        prefix_cache_pages=args.prefix_cache_pages, host_tier_pages=args.host_tier_pages,
        prefill_budget=args.prefill_budget, max_queue=args.max_queue,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id, seed=args.seed, quant_health_every=args.quant_health_every,
        spec_draft_len=args.spec_draft)
    plan = FaultPlan.parse(args.inject) if args.inject else None
    reqs = [Request(rid=i, prompt=p, max_new=args.gen, arrival=float(i * args.arrival_gap),
                    ttft_deadline=args.ttft_deadline or None,
                    deadline=args.deadline or None)
            for i, p in enumerate(prompts)]

    def new_engine(preemption=None):
        return engine_mod.ServingEngine(cfg, params, ecfg, fault_plan=plan,
                                        preemption=preemption, tracer=tracer, device=device)

    restarts: list[int] = []
    ckpt_dir = None
    if args.restartable:
        import tempfile
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_ckpt_")

        def on_restart(n: int) -> None:
            restarts.append(n)
            log("engine_restart", f"[serve] engine restart #{n} (restoring from {ckpt_dir})",
                restart=n, ckpt_dir=ckpt_dir)

        engine, results = run_restartable(new_engine, reqs, args, ckpt_dir, on_restart)
    else:
        engine = new_engine()
        results = engine.run(reqs)
    m = engine.metrics()
    n_done = sum(1 for r in results if r.status == "done")
    log("engine_summary",
        f"[serve] engine: {len(results)} requests over {ecfg.max_batch} slots, "
        f"{m['steps']} steps, {m['wall']['decode_tok_per_s']:.1f} tok/s (decode), "
        f"prefill {m['prefill']['mode']} (chunk={m['prefill']['chunk']}, "
        f"traces={m['prefill']['traces']}), pages peak {m['pages']['peak_in_use']}/"
        f"{m['pages']['capacity']} (saved by sharing: {m['pages']['saved_by_sharing']}), "
        f"evictions: {m['evictions']} (requeued: {m['requeues']}) [{device}]",
        requests=len(results), slots=ecfg.max_batch, steps=m["steps"],
        decode_tok_per_s=m["wall"]["decode_tok_per_s"], prefill_mode=m["prefill"]["mode"],
        chunk=m["prefill"]["chunk"], prefill_traces=m["prefill"]["traces"],
        pages_peak=m["pages"]["peak_in_use"], pages_capacity=m["pages"]["capacity"],
        saved_by_sharing=m["pages"]["saved_by_sharing"], evictions=m["evictions"],
        requeues=m["requeues"], roofline=m["roofline"], device=str(device))
    f = m["faults"]
    if plan or args.restartable or f["rejected"] or f["deadline_cancelled"] \
            or f["backend_faults"] or f["nonfinite_rows"]:
        log("engine_faults",
            f"[serve] faults: injected={len(f['injected'])} "
            f"quarantined={f['nonfinite_rows']} (recovered via the reference backend: "
            f"{f['recovered_ref']}, failed: {f['failed_nonfinite']}), "
            f"backend faults={f['backend_faults']}, "
            f"deadline cancels={f['deadline_cancelled']}, rejected={f['rejected']}, "
            f"preemptions={f['preemptions']}, restores={f['restores']} -> "
            f"{n_done}/{len(results)} completed",
            completed=n_done, total=len(results),
            **{k: v for k, v in f.items() if k != "injected"}, injected=len(f["injected"]))
    sp = m["speculative"]
    if sp["enabled"]:
        log("spec_decode",
            f"[serve] speculative: draft_len={sp['draft_len']}, {sp['verify_steps']} "
            f"verify steps, drafted {sp['drafted_tokens']} / accepted "
            f"{sp['accepted_tokens']} (accept rate {sp['accept_rate']:.3f}), "
            f"{sp['accepted_tokens_per_step']:.3f} tokens/slot-step", **sp)
    pc = m["prefix_cache"]
    if pc["budget_pages"] or pc["host_tier_pages"]:
        log("prefix_cache",
            f"[serve] prefix cache: {pc['cached']} pages retained (budget "
            f"{pc['budget_pages']}), reused {pc['reused_cached']}, restored from host "
            f"{pc['restored_host']} (offloads {pc['offloads']}, tier "
            f"{pc['host_used']}/{pc['host_tier_pages']}), prefill tokens "
            f"skipped {pc['prefill_skipped_tokens']}, HBM high-water "
            f"{pc['peak_resident']} pages", **pc)
    if engine.quant_probe is not None and engine.quant_probe.samples:
        last = engine.quant_probe.samples[-1]
        log("quant_health",
            f"[serve] quant health ({cfg.kv_fmt}, every {args.quant_health_every} steps, "
            f"{len(engine.quant_probe.samples)} samples): scale "
            f"[{last['scale_min']:.3g}, {last['scale_max']:.3g}], clip rate max "
            f"{last['clip_rate_max']:.3g}, sink err bound {last['sink_err_bound_max']:.3g}",
            fmt=cfg.kv_fmt, every=args.quant_health_every,
            samples=len(engine.quant_probe.samples), **last)
    if tracer is not None:
        tracer.write(args.trace_out)
        with open(args.trace_out) as fh:
            stats = validate_chrome_trace(json.load(fh), expect_requests=len(reqs))
        log("trace_written",
            f"[serve] trace: {args.trace_out} ({stats['events']} events, "
            f"{stats['requests']} request tracks, {stats['spans']} spans; "
            f"clock={tracer.clock})", path=args.trace_out, clock=tracer.clock, **stats)
    n_raised = sum(1 for ev in f["injected"] if ev[1] == "backend_raise")
    if f["backend_faults"] != n_raised or f["ref_fallback_steps"] != n_raised:
        raise SystemExit(f"[serve] FATAL: {f['backend_faults'] - n_raised} decode or "
                         "verify dispatches raised and ran on the reference backend "
                         "without an injected fault")
    if m["pages"]["free"] + m["pages"]["cached"] != m["pages"]["capacity"]:
        raise SystemExit("[serve] FATAL: engine drained but pages leaked "
                         f"({m['pages']['free']} free + {m['pages']['cached']} cached != "
                         f"{m['pages']['capacity']} capacity)")
    if (plan or args.restartable) and n_done == 0:
        raise SystemExit("[serve] FATAL: fault drill left zero completed requests")
    if args.prefill_chunk > 0:
        n_buckets = len(ST.chunk_buckets(args.prefill_chunk))
        if m["prefill"]["traces"] > n_buckets:
            raise SystemExit("[serve] FATAL: chunked prefill dispatched "
                             f"{m['prefill']['traces']} chunk widths > {n_buckets} buckets")
    if args.temperature <= 0 and m["requeues"] == 0:
        # greedy parity oracle: completed requests token-identical to the
        # static-batch generate path, per prompt-length group
        by_len: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        ref: dict[int, list[int]] = {}
        for rids in by_len.values():
            batch = torch.from_numpy(np.stack([prompts[i] for i in rids])).long().to(device)
            toks_ref, _ = generate(cfg, params, batch, args.gen, eos_id=args.eos_id,
                                   seed=args.seed)
            for row, rid in zip(toks_ref.cpu().tolist(), rids):
                ref[rid] = row
        bad = [r.rid for r in results if r.status == "done"
               and r.tokens != ref[r.rid][:len(r.tokens)]]
        if bad:
            raise SystemExit("[serve] FATAL: engine tokens diverge from the "
                             f"static-batch generate oracle for {bad}")
        log("engine_parity",
            f"[serve] engine parity vs static-batch generate: exact ({n_done} "
            "completed requests)", parity="exact", completed=n_done)
    return {"engine": engine, "results": results, "metrics": m, "prompts": prompts,
            "tracer": tracer, "restarts": restarts, "ckpt_dir": ckpt_dir}


def build_parser() -> argparse.ArgumentParser:
    """The command line of ``serve`` (``main`` parses it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mla-7b", choices=ARCH_IDS,
                    help="model; --engine takes the pure-MLA mla-7b and deepseek-v3-mla")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fmt", default="fp8_e4m3", choices=["fp8_e4m3", "int8", "none"])
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool for the MLA layers (latent entries in a "
                         "page pool addressed through per-sequence page tables) "
                         "instead of the contiguous per-slot cache")
    ap.add_argument("--backend", default="auto", choices=["auto", "ref", "kernel", "shard-map"],
                    help="decode attention: 'ref' = plain PyTorch, 'kernel' = the "
                         "hand-written Hopper kernels (plain versions on CPU), "
                         "'shard-map' = the collective-free local_map region over "
                         "the host (data, model) mesh (contiguous caches; batch must "
                         "divide the data axis; a world of one without a launcher), "
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
    ap.add_argument("--fused", action="store_true",
                    help="generate_fused: one decode step captured once as a CUDA graph "
                         "and replayed per token (eager on the CPU) instead of the "
                         "per-step loop")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching serving engine over one shared paged "
                         "pool (allocator with prefix sharing, FCFS slots, staggered "
                         "arrivals); greedy runs are gated against generate")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="engine decode slots (0 = one per request)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine chunked prefill: admit prompts in chunks of this many "
                         "tokens (bucketed to powers of two) alongside the decode; "
                         "0 = one-shot prefill")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens per engine step under --prefill-chunk "
                         "(the FCFS head always gets one chunk; 0 = one chunk per "
                         "prefilling request)")
    ap.add_argument("--prompt-lens", default="",
                    help="engine: comma list of prompt lengths cycled over --batch "
                         "requests, overriding --prompt-len")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="engine pool pages (0 = max_batch full spans + scratch)")
    ap.add_argument("--arrival-gap", type=int, default=1,
                    help="engine virtual steps between request arrivals")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="disable the engine's refcounted prefix sharing")
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="engine radix prefix cache: retain up to this many "
                         "refcount-0 prefix pages (0 = off)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="engine workload: the first N tokens identical in every request")
    ap.add_argument("--spec-draft", type=int, default=0,
                    help="engine self-speculative decoding: draft up to this many tokens "
                         "per slot per step by n-gram lookup, verified in ONE q_len > 1 "
                         "split-KV dispatch (0 = off)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="engine admission-queue bound (0 = unbounded)")
    ap.add_argument("--ttft-deadline", type=int, default=0,
                    help="engine TTFT deadline in virtual steps (0 = none)")
    ap.add_argument("--deadline", type=int, default=0,
                    help="engine total-latency deadline in virtual steps (0 = none)")
    ap.add_argument("--host-tier-pages", type=int, default=0,
                    help="engine host-memory tier: LRU-evicted cached prefix pages offload "
                         "their FP8 bytes to this many pinned host slots and come back on "
                         "a match instead of being recomputed (needs --prefix-cache-pages; "
                         "0 = off)")
    ap.add_argument("--inject", action="append", default=[],
                    metavar="KIND:STEP[:SLOT][:sticky]",
                    help="engine fault injection (repeatable): nan_logits:step:slot[:sticky], "
                         "alloc_fail:step[:count], backend_raise:step, preempt:step (needs "
                         "--restartable)")
    ap.add_argument("--restartable", action="store_true",
                    help="engine checkpoint/restart drill: run under run_with_restarts and a "
                         "PreemptionHandler with snapshots to --ckpt-dir; a preemption "
                         "(SIGTERM/SIGINT or --inject preempt:k) snapshots, ends the attempt, "
                         "and the restart restores the latest snapshot token-identically")
    ap.add_argument("--ckpt-dir", default="",
                    help="engine snapshot directory for --restartable (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="snapshot cadence in engine steps under --restartable (a "
                         "preemption always snapshots)")
    ap.add_argument("--trace-out", default="",
                    help="engine: write a Chrome trace-event JSON of the run (request "
                         "lifecycle spans, step phases, pool counters) to this path, "
                         "validated on write")
    ap.add_argument("--trace-clock", default="virtual", choices=["virtual", "wall"],
                    help="trace timestamps: 'virtual' = step*1000+offset ticks "
                         "(byte-identical across same-seed runs), 'wall' = host "
                         "microseconds")
    ap.add_argument("--quant-health-every", type=int, default=0,
                    help="engine: sample FP8 quantization health of the live pool (scale "
                         "range and exponent histogram, clip rate, sink error bound) every "
                         "N steps (0 = off)")
    ap.add_argument("--log-json", action="store_true",
                    help="engine: print each status line as one JSON object")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.engine and args.fused:
        ap.error("--engine has no fused mode (it steps the decode loop "
                 "per engine tick); drop --fused or --engine")

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
    started = not dist.is_initialized()
    if args.backend == "shard-map":
        # the shard_map backend needs a mesh context (serve.py:632-636): the
        # host mesh, data = every rank of the world
        T.SHARD_CTX = {"mesh": make_host_mesh(1, device), "dp": "data",
                       "use_shard_map": True}
    try:
        _serve(cfg, args, device)
    finally:
        if args.backend == "shard-map":
            T.SHARD_CTX = None
            if started and dist.is_initialized():
                dist.destroy_process_group()


def _serve(cfg, args, device) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_model(gen, cfg, device=device)
    if args.engine:
        run_engine(cfg, params, args)
        return
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int64)
    # the encoder families' frame / patch embeddings (serve.py:661-662)
    aux = torch.randn((args.batch, cfg.n_aux_tokens, cfg.d_model), generator=gen,
                      device=device) if cfg.n_aux_tokens else None
    sample_kw = dict(aux_embed=aux, temperature=args.temperature, top_k=args.top_k,
                     top_p=args.top_p, eos_id=args.eos_id, seed=args.seed)
    gen_fn = generate_fused if args.fused else generate
    toks, tps = gen_fn(cfg, params, prompts, args.gen, **sample_kw)
    mode = "fused-graph" if args.fused else "step-loop"
    cache_kind = "paged" if args.paged else "contiguous"
    print(f"[serve] {cfg.name} fmt={args.fmt} backend={args.backend} "
          f"rescale={args.rescale} ({mode}, {cache_kind} cache, {device}): "
          f"generated {tuple(toks.shape)} at {tps:.1f} tok/s (decode)")
    if T.SHARD_CTX is not None:
        print(f"[serve] rank {dist.get_rank()} of {dist.get_world_size()} "
              f"(mesh {tuple(T.SHARD_CTX['mesh'].shape)}): tokens {toks.tolist()}")
    if args.fmt != "none":
        cfg_b = dataclasses.replace(cfg, kv_fmt="none")
        toks_b, _ = gen_fn(cfg_b, params, prompts, args.gen, **sample_kw)
        agree = float(torch.mean((toks == toks_b).float()))
        print(f"[serve] token agreement vs BF16 pipeline: {agree * 100:.1f}%")


if __name__ == "__main__":
    main()
