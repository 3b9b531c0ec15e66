"""The port's span tracer (``repro_torch/obs/trace.py``), trace report
(``obs/trace_report.py``) and FP8 pool probe (``obs/quant_health.py``), and
the engine's hooks for them, against the JAX package.

  * the tracer's own contracts (``tests/test_obs.py:112``, ``:138``);
  * ``probe_pools`` on the same pool bytes as the reference's, with scales
    placed just below (and at) powers of two: the reports are equal dict for
    dict, and the port's sample makes one device-to-host copy;
  * the engine on the smoke mla-7b with bridged weights against the JAX
    engine (reference backends) on the workload of ``tests/test_obs.py:164``:
    the virtual-clock Chrome trace equal to the JAX engine's event for event
    (no key left out), the probes not perturbing a token (``:190``), the
    probe seeing resident fp8 pages (``:201``), a restored run continuing the
    same trace (``:218``), and the trace report's tables equal to the
    engine's numbers (``:261``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import kvcache as jkv
from repro.models import transformer as JT
from repro.obs import quant_health as jqh
from repro.obs import trace as jtrace
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.kvcache import page_aligned_capacity
from repro_torch.obs import quant_health as tqh
from repro_torch.obs import trace_report
from repro_torch.obs.trace import TICKS_PER_STEP, SpanTracer, validate_chrome_trace
from repro_torch.serving import engine as tengine
from repro_torch.serving import scheduler as tsched

CHUNK = 16


# ---------------------------------------------------------------------------
# tracer (no engine)
# ---------------------------------------------------------------------------

def test_tracer_virtual_clock_spans_and_validation():
    tr = SpanTracer()
    tr.req_begin(0, "QUEUED", tr.ts(2, 50), args={"prompt_len": 8})
    with pytest.raises(RuntimeError):
        tr.req_begin(0, "PREFILL", tr.ts(3))
    tr.req_transition(0, "PREFILL", tr.ts(3, 50))
    tr.req_chunk(0, 3)
    tr.req_transition(0, "DECODE", tr.ts(4, 445))
    with pytest.raises(RuntimeError):
        tr.chrome_payload()
    tr.req_end(0, tr.ts(6, 860))
    tr.req_instant(0, "DONE", tr.ts(6, 860), args={"tokens": 3})
    tr.step_phase(5, "decode", args={"rows": 1})
    tr.counter(5, "pages", {"in_use": 2, "free": 6})
    payload = tr.chrome_payload()
    stats = validate_chrome_trace(payload, expect_requests=1)
    assert stats["requests"] == 1 and stats["terminal"] == 1
    spans = {e["name"]: e for e in payload["traceEvents"]
             if e.get("ph") == "X" and e.get("pid") == 2}
    assert spans["QUEUED"]["ts"] // TICKS_PER_STEP == 2
    assert spans["DECODE"]["ts"] // TICKS_PER_STEP == 4
    assert (spans["DECODE"]["ts"] + spans["DECODE"]["dur"]) // TICKS_PER_STEP == 6


def test_validate_rejects_leaked_and_malformed_tracks():
    tr = SpanTracer()
    tr.req_begin(0, "QUEUED", tr.ts(0))
    tr.req_end(0, tr.ts(1))
    with pytest.raises(ValueError, match="terminal"):
        validate_chrome_trace(tr.chrome_payload())
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"traceEvents": []})
    with pytest.raises(ValueError, match="clock"):
        SpanTracer(clock="gpu")


# ---------------------------------------------------------------------------
# probe_pools on the same bytes
# ---------------------------------------------------------------------------

def _probe_pools(fmt, seed):
    """Random stored codes (some at qmax), per-row scales drawn from just
    below, at and just above powers of two (unwritten rows 0), three layers;
    the reference pool stacks them as one scanned leaf."""
    rng = np.random.default_rng(seed)
    L, n_pages, page, d_c = 3, 6, 8, 16
    qmax = 448.0 if fmt == "fp8_e4m3" else 127.0
    k = rng.integers(-24, 9, size=(L, n_pages, page)).astype(np.float32)
    base = np.exp2(k).astype(np.float32)
    pick = rng.integers(0, 3, size=base.shape)
    scale = np.where(pick == 0, np.nextafter(base, np.float32(0)),
                     np.where(pick == 1, base, np.nextafter(base, np.float32(np.inf))))
    scale = np.where(rng.random(base.shape) < 0.2, 0.0, scale).astype(np.float32)
    codes = rng.uniform(-qmax, qmax, size=(L, n_pages, page, d_c))
    codes[rng.random(codes.shape) < 0.05] = qmax
    if fmt == "fp8_e4m3":
        import ml_dtypes
        content = codes.astype(ml_dtypes.float8_e4m3fn)
    else:
        content = np.round(codes).astype(np.int8)
    cfg = jkv.CacheConfig(fmt=fmt, page_size=page)
    jpool = jkv.init_paged_mla_pool(cfg, n_pages, 2, 1, d_c, 4)
    jstack = jpool._replace(content=content, scale=scale,
                            rope=np.zeros((L, n_pages, page, 4), np.float32))
    tpools = [bridge.pool_from_jax(jpool._replace(content=content[i], scale=scale[i],
                                                  rope=np.asarray(jpool.rope)))
              for i in range(L)]
    return jstack, tpools


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
def test_probe_pools_equals_reference_on_same_bytes(fmt, monkeypatch):
    for seed, resident, sinks in ((0, {0, 2, 3, 5}, {0, 3}), (1, {1, 4}, set()),
                                  (2, set(), set()), (3, {0, 1, 2, 3, 4, 5}, {5, 1})):
        jstack, tpools = _probe_pools(fmt, seed)
        want = jqh.probe_pools(lambda fn, state: [fn(p) for p in state], [jstack], fmt=fmt,
                               resident_pages=resident, sink_pages=sinks)
        copies = []
        cpu = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda t: copies.append(t.shape) or cpu(t))
        got = tqh.probe_pools(tpools, fmt=fmt, resident_pages=resident, sink_pages=sinks)
        monkeypatch.undo()
        assert got == want
        assert len(copies) == 1
        if resident:
            hist = got["layers"]["pool0.0"]["scale_exp_hist"]
            assert len(hist) > 1


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_smoke("mla-7b"), t_smoke("mla-7b")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _workload(port, cfg, n=3, S=24, gen=5):
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(11), (n, S), 0, cfg.vocab_size,
                                            jax.numpy.int32))
    sched = tsched if port else jsched
    return [sched.Request(rid=i, prompt=prompts[i], max_new=gen, arrival=float(i))
            for i in range(n)], S, gen


def _engine(port, model, S, gen, *, tracer=None, health=0):
    jcfg, tcfg, jparams, tparams = model
    span = page_aligned_capacity(S + gen, jcfg.page_size) // jcfg.page_size
    mod = tengine if port else jengine
    cfg = dataclasses.replace(tcfg if port else jcfg, prefill_chunk=CHUNK)
    extra = {"device": "cpu"} if port else {}
    return mod.ServingEngine(cfg, tparams if port else jparams, mod.EngineConfig(
        max_batch=2, max_pages_per_seq=span, quant_health_every=health), tracer=tracer,
        **extra)


def _traced_run(port, model):
    reqs, S, gen = _workload(port, model[0])
    tracer = SpanTracer() if port else jtrace.SpanTracer()
    engine = _engine(port, model, S, gen, tracer=tracer, health=2)
    return engine, tracer, engine.run(reqs)


@pytest.fixture(scope="module")
def traced(model):
    return _traced_run(False, model), _traced_run(True, model)


def test_trace_equals_jax_engine_event_for_event(traced):
    """tests/test_obs.py:164's workload: the port's virtual-clock trace is
    the JAX engine's, every event and every key; the registry's work
    snapshot equal too; the trace reproduces the engine's TTFT / latency."""
    (je, jt, jres), (te, tt, tres) = traced
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    payload = tt.chrome_payload()
    assert payload == jt.chrome_payload()
    # the probe's scale gauges read pool scales that the two packages'
    # float32 matmuls may round apart in the last bit (ROADMAP queue 3):
    # equal within 1e-6; every other entry of the work snapshot exactly
    tw, jw = te.telemetry()["work"], je.telemetry()["work"]
    scales = ("snapmla_quant_scale_min", "snapmla_quant_scale_max",
              "snapmla_quant_sink_err_bound_max")
    for k in scales:
        assert tw.pop(k)["values"][""] == pytest.approx(jw.pop(k)["values"][""], rel=1e-6)
    assert tw == jw
    validate_chrome_trace(payload, expect_requests=len(tres))
    ev = [e for e in payload["traceEvents"] if e.get("pid") == 2]
    for r in tres:
        mine = [e for e in ev if e.get("tid") == r.rid]
        queued = min(e["ts"] for e in mine if e.get("name") == "QUEUED")
        first = next(e["ts"] for e in mine if e.get("name") == "FIRST_TOKEN")
        done = next(e["ts"] for e in mine if e.get("name") == "DONE")
        assert first // TICKS_PER_STEP - queued // TICKS_PER_STEP == r.ttft_steps
        assert done // TICKS_PER_STEP - queued // TICKS_PER_STEP == r.latency_steps


def test_probes_do_not_perturb_greedy_tokens(model, traced):
    reqs, S, gen = _workload(True, model[0])
    base = [r.tokens for r in _engine(True, model, S, gen).run(reqs)]
    assert [r.tokens for r in traced[1][2]] == base


def test_quant_probe_sees_resident_fp8_pages(traced):
    """tests/test_obs.py:201 on the port; the samples' resident page counts
    and written rows equal the JAX engine's."""
    (je, _, _), (te, _, _) = traced
    probe = te.quant_probe
    assert probe is not None and len(probe.samples) >= 2
    mid = [s for s in probe.samples if s["resident_pages"] > 0]
    assert mid, "no quant sample saw live pages"
    assert all(s["scale_max"] > 0 for s in mid)
    assert all(0.0 <= s["clip_rate_max"] <= 1.0 for s in mid)
    assert [(s["step"], s["resident_pages"]) for s in probe.samples] == \
        [(s["step"], s["resident_pages"]) for s in je.quant_probe.samples]


def test_restore_continues_same_trace(model, tmp_path):
    """tests/test_obs.py:218: a fresh engine restores a mid-run snapshot,
    resubmits the same workload and drains; its trace equals the
    uninterrupted run's (and the JAX engine's), with no duplicate span id."""
    payloads = []
    for port, sub in ((False, "jax"), (True, "port")):
        d = tmp_path / sub
        reqs, S, gen = _workload(port, model[0])
        tracer_a = SpanTracer() if port else jtrace.SpanTracer()
        engine_a = _engine(port, model, S, gen, tracer=tracer_a)
        res_a = engine_a.run(reqs, ckpt_dir=str(d), ckpt_every=3)
        full = tracer_a.chrome_payload()
        ckpt = sorted(p for p in d.iterdir() if p.name.startswith("step_"))[0]
        tracer_b = SpanTracer() if port else jtrace.SpanTracer()
        engine_b = _engine(port, model, S, gen, tracer=tracer_b)
        engine_b.restore(str(ckpt))
        assert engine_b.step_idx > 0
        assert len(engine_b.scheduler.finished) < len(reqs)
        res_b = engine_b.run(_workload(port, model[0])[0])
        assert [r.tokens for r in res_b] == [r.tokens for r in res_a]
        assert json.dumps(tracer_b.chrome_payload(), sort_keys=True) == \
            json.dumps(full, sort_keys=True)
        sids = [e["sid"] for e in tracer_b._events]
        assert len(sids) == len(set(sids))
        assert engine_b.faults["restores"] == 1
        payloads.append(full)
    assert payloads[1] == payloads[0]


def test_trace_report_tables_match_engine(traced, tmp_path, capsys):
    _, tracer, results = traced[1]
    payload = tracer.chrome_payload()
    summary = trace_report.summarize(payload)
    by_rid = {r["rid"]: r for r in summary["requests"]}
    assert sorted(by_rid) == [r.rid for r in results]
    for r in results:
        row = by_rid[r.rid]
        assert row["ttft"] == r.ttft_steps
        assert row["latency"] == r.latency_steps
        assert row["outcome"] == "DONE"
        assert row["chunks"] >= 1
    assert summary["occupancy"]["in_use_peak"] > 0
    text = trace_report.render(summary, validate_chrome_trace(
        payload, expect_requests=len(results)))
    assert "ttft" in text and "pages: peak" in text
    path = tmp_path / "trace.json"
    tracer.write(str(path))
    import sys
    argv = sys.argv
    try:
        sys.argv = ["trace_report", str(path), "--expect-requests", str(len(results))]
        assert trace_report.main() == 0
        sys.argv = ["trace_report", str(path), "--expect-requests", "7"]
        assert trace_report.main() == 1
    finally:
        sys.argv = argv
    assert "pages: peak" in capsys.readouterr().out
