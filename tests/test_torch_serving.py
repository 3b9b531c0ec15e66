"""The port's serving engine and its host modules against the JAX package.

  * host modules (allocator with the radix prefix cache, prefix tree,
    scheduler, n-gram proposer, FaultPlan, metrics registry): the same seeded
    random sequences of operations through the reference's and the port's
    copies, results and exported states equal;
  * the engine: the port's ``ServingEngine`` on the mla-7b smoke config with
    bridged weights (plain versions of the kernels on the CPU) against the
    JAX engine on its kernel backend (Pallas in interpret mode: the same
    pipeline form) on the reference tests' workloads — staggered arrivals
    with prefix sharing, chunked admission, the budget bound, evict-to-
    requeue, speculative greedy: greedy tokens identical, and the
    deterministic counters (steps, pages saved by sharing, prefill and stall
    token series, peak pages, drafted / accepted) equal;
  * the port's own contracts: sampled runs reproducible per seed, sampled
    speculative equal to sampled sequential, chunk widths within the bucket
    count, the NaN quarantine and the backend fallback, a clean drain, the
    unported options refused, and ``serve --engine`` on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.obs import metrics as jmetrics
from repro.serving import allocator as jalloc
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import prefix_tree as jtree
from repro.serving import scheduler as jsched
from repro.serving import speculative as jspec
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.kvcache import page_aligned_capacity
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.obs import metrics as tmetrics
from repro_torch.serving import allocator as talloc
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import prefix_tree as ttree
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import speculative as tspec

PAGE, CHUNK = 16, 16


# ---------------------------------------------------------------------------
# host modules: the same operations through both copies
# ---------------------------------------------------------------------------

def _ops_storm(alloc_mod, seed, budget, n_ops=120):
    """A seeded interleaving of alloc_prompt (prompts sharing prefixes),
    mark_ready, grow and free; returns (op results, export_state)."""
    rng = np.random.default_rng(seed)
    a = alloc_mod.PageAllocator(20, PAGE, prefix_sharing=True, prefix_cache_pages=budget)
    stems = [rng.integers(0, 50, 3 * PAGE, dtype=np.int32) for _ in range(3)]
    live, out = [], []
    for _ in range(n_ops):
        op = rng.integers(0, 4)
        if op == 0 or not live:
            stem = stems[rng.integers(0, 3)]
            n = int(rng.integers(1, 3 * PAGE))
            prompt = np.concatenate([stem[:n], rng.integers(0, 50, rng.integers(0, PAGE),
                                                            dtype=np.int32)])
            got = a.alloc_prompt(prompt)
            out.append(None if got is None else (list(got), got.cached_tokens))
            if got is not None:
                pages = list(got)
                a.mark_ready(pages, len(prompt))
                live.append(pages)
        elif op == 1:
            grown = a.grow(1)
            out.append(grown)
            if grown is not None:
                live[int(rng.integers(0, len(live)))].extend(grown)
        else:
            pages = live.pop(int(rng.integers(0, len(live))))
            a.free(pages)
            out.append(("free", len(pages)))
        a.check_invariants()
    s = a.stats(7)
    return out, a.export_state(), dataclasses.asdict(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [0, 5])
def test_allocator_and_prefix_tree_match_reference(seed, budget):
    j = _ops_storm(jalloc, seed, budget)
    t = _ops_storm(talloc, seed, budget)
    assert t == j


def test_prefix_tree_matches_reference():
    trees = []
    for mod in (jtree, ttree):
        tree = mod.PrefixTree()
        a = tree.insert(b"a", tree.root, page_id=3)
        b = tree.insert(b"ab", a, page_id=5)
        tree.insert(b"abc", b, page_id=7)
        tree.insert(b"ax", a, page_id=9)
        tree.tick()
        tree.clear_device(b)
        tree.set_host(b, 1)
        tree.remove(tree.get(b"ax"))
        tree.check()
        trees.append((tree.export_state(), [n.key for n in tree.subtree_postorder(a)]))
    assert trees[0] == trees[1]


def _sched_storm(sched_mod, alloc_mod, seed):
    rng = np.random.default_rng(seed)
    alloc = alloc_mod.PageAllocator(12, PAGE)
    sched = sched_mod.Scheduler(3, max_queue=4)
    log, rid = [], 0
    for step in range(40):
        for _ in range(int(rng.integers(0, 3))):
            req = sched_mod.Request(rid=rid, prompt=rng.integers(0, 9, int(rng.integers(1, 40)),
                                                                 dtype=np.int32),
                                    max_new=4, arrival=float(step),
                                    deadline=int(rng.integers(5, 30)))
            rid += 1
            if sched.queue_full:
                sched.reject(req, step, "queue_full")
            else:
                sched.submit(req)
        for r in sched.admit(alloc, step):
            r.status = sched_mod.Status.DECODE
            r.out_tokens.append(1)
        act = sched.active
        if act:
            r = act[int(rng.integers(0, len(act)))]
            op = int(rng.integers(0, 3))
            if op == 0:
                sched.retire(r, step, alloc)
            elif op == 1:
                sched.requeue(r, alloc)
            else:
                victim = sched.eviction_victim(step)
                if victim is not None:
                    sched.fail(victim, step, alloc, "deadline")
        log.append(([q.rid for q in sched.queue],
                    [None if s is None else (s.rid, s.status.value, s.slot) for s in sched.slots],
                    [(f.rid, f.status.value, f.fail_reason) for f in sched.finished],
                    sched.requeues, sched.drained))
    return log, alloc.export_state()


@pytest.mark.parametrize("seed", [0, 3])
def test_scheduler_matches_reference(seed):
    assert _sched_storm(tsched, talloc, seed) == _sched_storm(jsched, jalloc, seed)


def test_proposer_matches_reference():
    rng = np.random.default_rng(4)
    outs = []
    for mod in (jspec, tspec):
        p = mod.NgramProposer(max_draft_len=4)
        log = []
        for i in range(60):
            rid = str(int(rng.integers(0, 3)))
            ctx = list(rng.integers(0, 6, int(rng.integers(2, 30))))
            d = p.propose(rid, ctx, int(rng.integers(0, 5)))
            acc = int(rng.integers(0, len(d) + 1))
            p.observe(rid, len(d), acc)
            if i % 17 == 16:
                p.drop(rid)
            log.append((d, p.draft_len(rid)))
        outs.append((log, p.export_state()))
        rng = np.random.default_rng(4)
    assert outs[0] == outs[1]


def test_fault_plan_matches_reference():
    specs = ["nan_logits:3:1", "nan_logits:5:0:sticky", "alloc_fail:2:3",
             "backend_raise:7", "preempt:9"]
    jp, tp = jfaults.FaultPlan.parse(specs), tfaults.FaultPlan.parse(specs)
    for step in range(12):
        assert [(e.kind, e.slot) for e in tp.nan_slots(step)] == \
            [(e.kind, e.slot) for e in jp.nan_slots(step)]
        assert tp.alloc_fail(step) == jp.alloc_fail(step)
        assert tp.backend_raise(step) == jp.backend_raise(step)
        assert tp.preempt(step) == jp.preempt(step)
        for slot in range(2):
            assert tp.retry_poisoned(step, slot) == jp.retry_poisoned(step, slot)
    assert tp.fired == jp.fired
    jr, tr = jfaults.FaultPlan.random(5, 30, 4), tfaults.FaultPlan.random(5, 30, 4)
    assert [dataclasses.asdict(e) for e in tr.events] == \
        [dataclasses.asdict(e) for e in jr.events]
    with pytest.raises(ValueError):
        tfaults.FaultPlan.parse(["bogus:1"])


def test_metrics_registry_matches_reference():
    snaps = []
    for mod in (jmetrics, tmetrics):
        r = mod.MetricsRegistry()
        c = r.counter("snapmla_engine_steps_total", "steps")
        g = r.gauge("snapmla_pages_free", "free")
        h = r.histogram("snapmla_engine_prefill_chunk_width", "w")
        f = r.counter("snapmla_engine_faults_total", "f", labels=("kind",))
        w = r.counter("snapmla_wall_decode_seconds_total", "s", wall=True)
        c.inc(3)
        g.set(7)
        g.dec(2)
        for v in (1, 16, 3, 100):
            h.observe(v)
        f.labels(kind="rejected").inc()
        w.inc(0.5)
        snaps.append((r.snapshot(include_wall=True), r.export_state()))
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_smoke("mla-7b"), decode_backend="kernel", use_kernels=True)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), decode_backend="kernel", use_kernels=True)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(seed, lens, common=0, vocab=256):
    rng = np.random.RandomState(seed)
    stem = rng.randint(0, vocab, common).astype(np.int32)
    return [np.concatenate([stem, rng.randint(0, vocab, n - common).astype(np.int32)])
            for n in lens]


def _span(S, gen):
    return page_aligned_capacity(S + gen, PAGE) // PAGE


def _run_pair(model, prompts, gen, arrivals, chunk=0, **ecfg_kw):
    """The same workload through the JAX engine and the port's."""
    jcfg, tcfg, jparams, tparams = model
    out = []
    for cfg, params, mod in ((jcfg, jparams, jengine), (tcfg, tparams, tengine)):
        ecfg = mod.EngineConfig(**ecfg_kw)
        kw = {"device": "cpu"} if mod is tengine else {}
        eng = mod.ServingEngine(dataclasses.replace(cfg, prefill_chunk=chunk), params, ecfg,
                                **kw)
        sched = jsched if mod is jengine else tsched
        res = eng.run([sched.Request(rid=i, prompt=p, max_new=gen, arrival=float(a))
                       for i, (p, a) in enumerate(zip(prompts, arrivals))])
        out.append(({r.rid: (r.status, r.tokens) for r in res}, eng.metrics()))
    return out


def _assert_same_run(j, t):
    (jres, jm), (tres, tm) = j, t
    assert tres == jres
    assert tm["steps"] == jm["steps"]
    assert tm["pages"] == jm["pages"]
    assert tm["prefill"]["tokens_series"] == jm["prefill"]["tokens_series"]
    assert tm["work"] == jm["work"]
    assert tm["fetch_work"] == jm["fetch_work"]
    assert tm["requeues"] == jm["requeues"] and tm["evictions"] == jm["evictions"]
    for k in ("verify_steps", "drafted_tokens", "accepted_tokens", "accepted_tokens_per_step"):
        assert tm["speculative"][k] == jm["speculative"][k], k
    assert all(v == 0 for k, v in tm["faults"].items() if k != "injected")
    assert tm["pages"]["free"] == tm["pages"]["capacity"]


def test_engine_staggered_arrivals_and_sharing_match_jax(model):
    """tests/test_serving.py:193's workload: 4 prompts of 40 sharing 32
    tokens, 2 slots, arrivals 0, 0, 3, 5, monolithic admission."""
    prompts = _prompts(2, [40] * 4, common=32)
    j, t = _run_pair(model, prompts, 8, [0, 0, 3, 5], max_batch=2,
                     max_pages_per_seq=_span(40, 8))
    _assert_same_run(j, t)
    assert t[1]["pages"]["saved_by_sharing"] > 0
    assert t[1]["prefill"]["traces"] == j[1]["prefill"]["traces"]


def test_engine_chunked_admission_matches_jax(model):
    """tests/test_serving.py:386's workload: lengths straddling the chunk
    (15, 16, 17, 40), chunk 16, 2 slots."""
    lens = [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + CHUNK // 2]
    j, t = _run_pair(model, _prompts(11, lens), 6, [0] * 4, chunk=CHUNK, max_batch=2,
                     max_pages_per_seq=_span(max(lens), 6))
    _assert_same_run(j, t)
    assert t[1]["prefill"]["traces"] == j[1]["prefill"]["traces"] <= \
        len(tsteps.chunk_buckets(CHUNK))


def test_engine_budget_bound_matches_jax(model):
    """tests/test_serving.py:467's workload: three 48-token prompts, budget
    = one chunk per step."""
    j, t = _run_pair(model, _prompts(14, [3 * CHUNK] * 3), 4, [0] * 3, chunk=CHUNK,
                     max_batch=3, max_pages_per_seq=_span(3 * CHUNK, 4), prefill_budget=CHUNK)
    _assert_same_run(j, t)
    series = t[1]["prefill"]["tokens_series"]
    assert max(series) <= CHUNK and sum(series) == 3 * 3 * CHUNK


def test_engine_evict_to_requeue_matches_jax(model):
    """tests/test_serving.py:247's workload: a pool too small for both slots
    to grow; the victim is requeued and replays."""
    j, t = _run_pair(model, _prompts(4, [20] * 3), 14, [0] * 3, max_batch=2,
                     max_pages_per_seq=3, n_pages=6, prefix_sharing=False)
    _assert_same_run(j, t)
    assert t[1]["evictions"] > 0 and t[1]["requeues"] == t[1]["evictions"]


def test_engine_speculative_greedy_matches_jax(model):
    """tests/test_serving.py:553's workload: three random prompts and one
    repetitive one, drafts of up to 3 verified by the q_len > 1 kernel's
    plain version; also identical to the port's non-speculative run."""
    prompts = _prompts(11, [24] * 3) + [np.asarray(([5, 9, 2, 7] * 6)[:24], np.int32)]
    kw = dict(max_batch=2, max_pages_per_seq=_span(24, 12))
    j, t = _run_pair(model, prompts, 12, [0] * 4, spec_draft_len=3, **kw)
    _assert_same_run(j, t)
    assert t[1]["speculative"]["accepted_tokens"] > 0
    _, t0 = _run_pair(model, prompts, 12, [0] * 4, **kw)
    assert t0[0] == t[0]


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _port_run(model, prompts, gen, chunk=0, fault_plan=None, **kw):
    _, tcfg, _, tparams = model
    eng = tengine.ServingEngine(dataclasses.replace(tcfg, prefill_chunk=chunk), tparams,
                                tengine.EngineConfig(**kw), fault_plan=fault_plan,
                                device="cpu")
    res = eng.run([tsched.Request(rid=i, prompt=p, max_new=gen, arrival=0.0)
                   for i, p in enumerate(prompts)])
    return {r.rid: (r.status, r.tokens) for r in res}, eng


def test_sampled_runs_reproducible_and_speculation_keeps_samples(model):
    prompts = _prompts(12, [24] * 2) + [np.asarray(([5, 9, 2, 7] * 6)[:24], np.int32)]
    kw = dict(max_batch=2, max_pages_per_seq=_span(24, 10), temperature=0.8, top_k=8,
              seed=7)
    a, _ = _port_run(model, prompts, 10, **kw)
    b, _ = _port_run(model, prompts, 10, **kw)
    c, eng = _port_run(model, prompts, 10, spec_draft_len=3, **kw)
    d, _ = _port_run(model, prompts, 10, **dict(kw, seed=8))
    assert a == b == c
    assert a != d
    assert eng.metrics()["speculative"]["verify_steps"] > 0


def test_chunked_sampled_reproducible_and_widths_bounded(model):
    lens = [7, 9, 15, 16, 17, 23, 33, 40]
    prompts = _prompts(13, lens)
    kw = dict(max_batch=3, max_pages_per_seq=_span(40, 4), temperature=0.7, seed=3)
    a, eng = _port_run(model, prompts, 4, chunk=CHUNK, **kw)
    b, _ = _port_run(model, prompts, 4, chunk=CHUNK, **kw)
    assert a == b and all(s == "done" for s, _ in a.values())
    assert eng.prefill_traces <= len(tsteps.chunk_buckets(CHUNK))
    m = eng.metrics()
    assert m["pages"]["free"] == m["pages"]["capacity"]


@pytest.mark.parametrize("spec", [0, 2])
def test_quarantine_and_backend_fallback(model, spec):
    """A non-sticky NaN row is recovered by the reference-backend retry, a
    sticky one fails its request, a raising dispatch degrades one step: the
    other requests' tokens equal the fault-free run's, and the counters
    record each event."""
    prompts = _prompts(21, [20] * 3)
    kw = dict(max_batch=3, max_pages_per_seq=_span(20, 6), spec_draft_len=spec)
    clean, _ = _port_run(model, prompts, 6, **kw)
    plan = tfaults.FaultPlan.parse(["nan_logits:2:0", "nan_logits:3:1:sticky",
                                    "backend_raise:4"])
    got, eng = _port_run(model, prompts, 6, fault_plan=plan, **kw)
    f = eng.metrics()["faults"]
    assert f["nonfinite_rows"] == 2 and f["recovered_ref"] == 1
    assert f["failed_nonfinite"] == 1 and f["backend_faults"] == 1
    assert f["ref_fallback_steps"] == 1
    assert got[1][0] == "failed" and got[0] == clean[0] and got[2] == clean[2]
    m = eng.metrics()
    assert m["pages"]["free"] == m["pages"]["capacity"]


def test_unported_engine_options_raise(model):
    _, tcfg, _, tparams = model
    for kw in (dict(host_tier_pages=2, prefix_cache_pages=2), dict(quant_health_every=2)):
        with pytest.raises(ValueError, match="not ported"):
            tengine.ServingEngine(tcfg, tparams, tengine.EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tengine.ServingEngine(tcfg, tparams, tengine.EngineConfig(), tracer=object(),
                              device="cpu")


def test_engine_warm_up_runs_plain_versions_on_cpu(model):
    _lib.reset_launches()
    _port_run(model, _prompts(1, [10]), 2, max_batch=1, max_pages_per_seq=1,
              spec_draft_len=2)
    assert sum(_lib.LAUNCHES.values()) == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_uninjected_raise_degrades_only_on_cpu(model, device):
    """A dispatch that raises by itself reruns on the reference backend only
    on CPU tensors; off the CPU the raise propagates."""
    _, eng = _port_run(model, _prompts(1, [10]), 1, max_batch=1, max_pages_per_seq=1)
    eng.device = torch.device(device)

    def boom(params, *args):
        raise RuntimeError("launch failed")

    def plain(params, *args):
        return "plain"

    if device == "cpu":
        assert eng._degrade(boom, plain) == "plain"
        f = eng.metrics()["faults"]
        assert f["backend_faults"] == 1 and f["ref_fallback_steps"] == 1
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            eng._degrade(boom, plain)


def test_serve_engine_fails_on_uninjected_fallback(monkeypatch):
    """``serve --engine`` exits non-zero when a decode dispatch fell back to
    the reference backend without an injected fault."""
    make = tsteps.make_decode_step

    def flaky_decode_step(cfg):
        step, calls = make(cfg), []

        def run(*args):
            calls.append(1)
            if len(calls) > 1:            # the warm-up passes, the engine's steps raise
                raise RuntimeError("launch failed")
            return step(*args)
        return run

    monkeypatch.setattr(tsteps, "make_decode_step", flaky_decode_step)
    with pytest.raises(SystemExit, match="without an injected fault"):
        tserve.main(["--engine", "--smoke", "--device", "cpu", "--backend", "kernel",
                     "--batch", "2", "--prompt-len", "12", "--gen", "3"])


@pytest.mark.parametrize("flags", [
    ["--prompt-lens", "40,13,25,16", "--shared-prefix", "12"],
    ["--prompt-lens", "40,13,25,16", "--prefill-chunk", "16", "--prefill-budget", "32"],
    ["--prompt-len", "24", "--spec-draft", "3", "--max-batch", "4"]])
def test_serve_engine_main_cpu(capsys, flags):
    """``serve --engine`` on the CPU: the greedy oracle gate and the leak and
    bucket checks pass."""
    tserve.main(["--engine", "--smoke", "--device", "cpu", "--backend", "kernel",
                 "--batch", "4", "--max-batch", "2", "--gen", "6", *flags])
    out = capsys.readouterr().out
    assert "engine parity vs static-batch generate: exact (4 completed" in out
    if "--spec-draft" in flags:
        assert "[serve] speculative: draft_len=3" in out
