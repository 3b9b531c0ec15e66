"""The port's serving engine on deepseek-v3-mla (MLA with q-LoRA and a MoE
MLP) against the JAX engine, with the same bridged smoke weights and the
reference command line's prompts (``--batch 4 --max-batch 2 --prompt-lens
40,13,25,16 --gen 4``, seed 0), monolithic, chunked (``--prefill-chunk 16
--prefill-budget 32``) and speculative (``--spec-draft 3``):

  * the port's greedy engine tokens equal the JAX engine's, per request (the
    JAX engine on its default reference backend, as the command runs it);
  * the expert capacity depends on how many tokens share a MoE call, so the
    engine's batches and ``generate``'s static batch drop different tokens:
    both packages' engines diverge from their ``generate`` on the same
    request ids, pinned here (request 3 on the monolithic workload);
  * the port's ``serve --engine`` gate exits non-zero naming those ids, as
    the reference's does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.kvcache import page_aligned_capacity
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as tengine
from repro_torch.serving import scheduler as tsched

BASE = ["--engine", "--batch", "4", "--max-batch", "2", "--prompt-lens", "40,13,25,16",
        "--gen", "4"]
WORKLOADS = {"monolithic": [], "chunked": ["--prefill-chunk", "16", "--prefill-budget", "32"],
             "speculative": ["--spec-draft", "3"]}
# request ids whose engine tokens differ from generate's (both packages)
DIVERGENT = {"monolithic": [3], "chunked": [0, 1, 2, 3], "speculative": []}


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke("deepseek-v3-mla")                    # the default backend: ref
    tcfg = dataclasses.replace(t_smoke("deepseek-v3-mla"), decode_backend="kernel",
                               use_kernels=True)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def _args(flags):
    return tserve.build_parser().parse_args(BASE + flags)


def _prompts(jcfg, args):
    """The reference command's prompts (``serve._engine_prompts``, seed 0)."""
    return jserve._engine_prompts(jcfg, jax.random.PRNGKey(args.seed), args)


def _engine_tokens(mod, sched, cfg, params, prompts, args, **kw):
    span = page_aligned_capacity(max(map(len, prompts)) + args.gen, cfg.page_size) \
        // cfg.page_size
    eng = mod.ServingEngine(
        dataclasses.replace(cfg, prefill_chunk=args.prefill_chunk), params,
        mod.EngineConfig(max_batch=args.max_batch, max_pages_per_seq=span,
                         prefill_budget=args.prefill_budget, spec_draft_len=args.spec_draft),
        **kw)
    res = eng.run([sched.Request(rid=i, prompt=p, max_new=args.gen,
                                 arrival=float(i * args.arrival_gap))
                   for i, p in enumerate(prompts)])
    assert all(r.status == "done" for r in res)
    m = eng.metrics()
    assert m["pages"]["free"] == m["pages"]["capacity"] and m["requeues"] == 0
    return {r.rid: list(map(int, r.tokens)) for r in res}


def _oracle(generate, to_batch, cfg, params, prompts, gen):
    """``generate``'s tokens per request, one static batch per prompt length
    (``run_engine``'s grouping)."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        rids = [i for i, p in enumerate(prompts) if len(p) == n]
        toks = generate(cfg, params, to_batch(np.stack([prompts[i] for i in rids])), gen)[0]
        for rid, row in zip(rids, np.asarray(toks).tolist()):
            out[rid] = row
    return out


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_engine_matches_jax_engine_and_shares_its_divergence(model, workload):
    jcfg, tcfg, jparams, tparams = model
    args = _args(WORKLOADS[workload])
    prompts = _prompts(jcfg, args)
    j_toks = _engine_tokens(jengine, jsched, jcfg, jparams, prompts, args)
    t_toks = _engine_tokens(tengine, tsched, tcfg, tparams, prompts, args, device="cpu")
    assert t_toks == j_toks
    j_ref = _oracle(jserve.generate, jnp.asarray, jcfg, jparams, prompts, args.gen)
    t_ref = _oracle(tserve.generate, lambda a: torch.from_numpy(a).long(), tcfg, tparams,
                    prompts, args.gen)
    assert t_ref == j_ref
    diverge = [rid for rid in sorted(j_toks) if j_toks[rid] != j_ref[rid]]
    assert [rid for rid in sorted(t_toks) if t_toks[rid] != t_ref[rid]] == diverge
    assert diverge == DIVERGENT[workload]


def test_serve_engine_gate_names_the_divergent_requests(model, monkeypatch):
    """``serve --engine`` on the reference command's prompts and weights:
    the port's gate exits naming request 3, as the reference's does
    ("engine tokens diverge from the static-batch generate oracle for
    [3]")."""
    jcfg, tcfg, _, tparams = model
    args = _args([])
    monkeypatch.setattr(tserve, "_engine_prompts", lambda cfg, a: _prompts(jcfg, a))
    with pytest.raises(SystemExit, match=r"generate oracle for \[3\]"):
        tserve.run_engine(tcfg, tparams, args)
