"""Offline batch decode through the program's fused decode loop
(``launch/steps.make_fused_decode``: one step run eagerly, captured as a CUDA
graph, replayed per token), in closed-loop rounds over a paged FP8 pool whose
contexts were built in set-up.

Workload keys: ``batch``; ``context`` (a size distribution, see
``traffic.stratified``); ``round_tokens`` (steps per fused call);
``max_rounds`` (the pool's room; the window also ends there); ``kv_fmt``,
``page_size``, ``backend``, ``kv_splits``, ``rescale``; ``latent_block``
(prompt positions per latent block); ``check``: ``per_round`` positions
checked in a round (its last always), ``rounds`` (the last always),
``rows`` (a dense model's rows followed; an MoE model's are all of them)
and the ``limits``."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from harness import check, model, trace, traffic
from harness.common import sub_seed


def build(conf: dict, wl: dict, seed: int, device):
    """Set-up: the program's config, the weights, the traffic and the pool
    filled with every row's prompt latents."""
    from repro_torch.core.kvcache import CacheConfig, paged_mla_prefill_at
    from repro_torch.models import transformer as T
    cfg = model.port_config(conf, kv_fmt=wl["kv_fmt"], page_size=wl["page_size"],
                            kv_paged=True, kv_pool_pages=0, kv_splits=wl["kv_splits"],
                            kv_rescale=wl["rescale"], decode_backend=wl["backend"],
                            use_kernels=wl["backend"] == "kernel")
    params = model.make_weights(cfg, sub_seed(seed, "weights"), device)
    plain = model.plain_weights(params)
    B, n = wl["batch"], wl["round_tokens"]
    ctx = torch.as_tensor(traffic.decode_contexts(wl, seed), device=device)
    hi = int(ctx.max())
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "tokens"))
    tokens = torch.randint(0, cfg.vocab_size, (B, hi + 1), generator=gen, device=device)
    first = tokens.gather(1, ctx[:, None].long())[:, 0].to(torch.int32)
    state = T.init_decode_state(cfg, B, hi + wl["max_rounds"] * n + 1, device=device)
    pages = state["layers"][0].page_table.shape[1]
    latents = model.PromptLatents(plain, tokens, cfg.rope_theta)
    ccfg = CacheConfig(fmt=cfg.kv_fmt, page_size=cfg.page_size)
    blk = wl["latent_block"]
    for li, pool in enumerate(state["layers"]):
        for t0 in range(0, hi, blk):
            c, k_r = latents(li, t0, min(t0 + blk, hi))
            valid = torch.ones(c.shape[:2], dtype=torch.bool, device=device)
            paged_mla_prefill_at(pool, ccfg, c, k_r, torch.full((B,), t0, device=device), valid)
            del c, k_r
        state["layers"][li] = pool._replace(seq_lens=ctx.to(torch.int32).clone())
    return SimpleNamespace(cfg=cfg, params=params, plain=plain, ctx=ctx, tokens=tokens,
                           first=first, state=state, latents=latents, pages=pages)


def _reset(state, ctx):
    for pool in state["layers"]:
        pool.seq_lens.copy_(ctx)


def run(conf: dict, wl: dict, seed: int, seconds: float, traced: bool, device, *,
        t_start: float, readers: dict, control: bool = False):
    """One run: its metrics, ``correct`` and the numbers compared, the rows
    attempted and failed, the memory peak and the trace's breakdown. With
    ``control`` the reference is also computed one precision lower (TF32)
    at the same positions, and its readings returned as ``control``."""
    from repro_torch.launch import steps as ST
    if device.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(device)
    cell = build(conf, wl, seed, device)
    cfg, B, n = cell.cfg, wl["batch"], wl["round_tokens"]
    ctx32 = cell.ctx.to(torch.int32)
    offsets = traffic.pick(n, wl["check"]["per_round"], seed, "offsets", always=[n - 1])
    fused = ST.make_fused_decode(cfg, n, return_logits=True)
    # warm-up: every kernel, the graph capture and the logits buffer of a round
    torch.empty((B, n, cfg.vocab_size), dtype=torch.float32, device=device)
    ST.make_fused_decode(cfg, 2, return_logits=True)(cell.params, cell.first, cell.state, ctx32)
    _sync(device)
    _reset(cell.state, ctx32)
    setup_s = time.perf_counter() - t_start

    served, kept, ok = [], [], True
    tok, pos = cell.first, ctx32.clone()
    with trace.profiled(traced, device) as get_trace:
        with trace.mark("window"):
            t0 = time.perf_counter()
            while True:
                with trace.mark("round"):
                    toks, _, ok_r, logits = fused(cell.params, tok, cell.state, pos)
                served.append(toks)
                kept.append(logits[:, offsets].clone())
                del logits
                ok = ok and bool(ok_r)
                tok, pos = toks[:, -1], pos + n
                if time.perf_counter() - t0 >= seconds or len(served) == wl["max_rounds"]:
                    break
            wall = time.perf_counter() - t0
    rounds = len(served)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del cell.state, fused
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    served = torch.cat(served, dim=1)                                    # [B, rounds * n]
    inputs = torch.cat([cell.first[:, None], served[:, :-1]], dim=1)
    chk = wl["check"]
    checked_rounds = traffic.pick(rounds, chk["rounds"], seed, "rounds", always=[rounds - 1])
    steps = [r * n + o for r in checked_rounds for o in offsets]
    prog = torch.stack([kept[r][:, j] for r in checked_rounds for j in range(len(offsets))])
    if cfg.moe is not None:
        rows = list(range(B))
    else:
        rows = traffic.pick(B, chk["rows"], seed, "rows", always=[int(cell.ctx.argmax())])
    rsel = torch.as_tensor(rows, device=device)
    ref_cfg = dict(model.dims(conf), block=wl["page_size"])
    from plainref import mla_fp8
    ref, routing = mla_fp8.decode(cell.plain, ref_cfg, cell.latents.rows(rows), cell.ctx[rsel],
                                  inputs[rsel], steps, "float32", wl["latent_block"])
    values = check.readings(ref, prog[:, rsel], served[rsel][:, steps].T)
    low = None
    if control:
        tf, _ = mla_fp8.decode(cell.plain, ref_cfg, cell.latents.rows(rows), cell.ctx[rsel],
                               inputs[rsel], steps, "tf32", wl["latent_block"])
        low = check.control_readings(ref, tf)
        low["spread"] = check.spread(ref, tf, tf.argmax(-1))
        low["program_spread"] = check.spread(ref, prog[:, rsel], served[rsel][:, steps].T)
    correct, compared = check.judge(values, chk["limits"])
    correct = correct and ok

    metrics = {}
    breakdown = None
    if traced:
        tr = get_trace()
        kept_pairs = [float(k.sum()) for step in routing for _, k in step]
        experts = [float(torch.unique(i[k]).numel()) for step in routing for i, k in step]
        calls = [(cell.ctx + r * n + i + 1).tolist() for r in range(rounds) for i in range(n)]
        run_view = SimpleNamespace(
            trace=tr, dims=ref_cfg, fmt=cfg.kv_fmt, decode_calls=calls, steps=len(calls),
            table_entries=cell.pages,
            experts_read=sum(experts) / len(experts) if experts else 0.0,
            pairs_kept=sum(kept_pairs) / len(kept_pairs) if kept_pairs else 0.0)
        for name, (unit, reader) in readers.items():
            value = reader(run_view)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        metrics = {"decode_tok_s": {"value": B * n * rounds / wall, "unit": "tokens/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        device_extra = {}
    return SimpleNamespace(metrics=metrics, correct=correct, compared=compared,
                           attempted=B * rounds, failed=0 if ok else B * rounds, peak=peak,
                           breakdown=breakdown, device_extra=device_extra, readings=values,
                           control=low)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
