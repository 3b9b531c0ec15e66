"""The port's checkpoints (``repro_torch/checkpoint/checkpoint.py``), its
fault-tolerance runtime (``runtime/fault_tolerance.py``) and the engine's
snapshot / restore with preemption, against the JAX package.

  * the assertions of ``tests/test_checkpoint.py:15`` and ``:29`` and of
    ``tests/test_fault_tolerance.py:32``, ``:48``, ``:72`` and ``:94``,
    against the port's functions and classes;
  * the engine on the smoke mla-7b with bridged weights against the JAX
    engine (reference backends) on the workloads of ``tests/test_chaos.py:284``
    (a mid-flight snapshot restored into a fresh engine), ``:314`` (an
    injected preemption under ``run_with_restarts``), ``:349`` (``keep``
    pruning) and ``tests/test_serving.py:658`` (the proposer's state rides the
    snapshot): tokens equal to the uninterrupted run and to the JAX engine's,
    and the deterministic counters (steps, pages, work, faults with the
    preemption and the restore) equal.
"""
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.runtime import fault_tolerance as jft
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import kvcache as tkv
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def test_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16), torch.tensor(7, dtype=torch.int32)]}
    CK.save_checkpoint(str(tmp_path), 5, tree, {"note": "x"})
    CK.save_checkpoint(str(tmp_path), 9, tree)
    latest = CK.latest_checkpoint(str(tmp_path))
    assert latest.endswith("step_00000009")
    loaded, manifest = CK.load_checkpoint(latest, tree)
    assert manifest["step"] == 9
    for (_, a), (_, b) in zip(CK.flatten(tree), CK.flatten(loaded)):
        assert a.dtype == b.dtype and torch.equal(a.float(), b.float())


def test_no_tmp_dirs_left(tmp_path):
    CK.save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_pool_tree_bytes_round_trip_and_keep(tmp_path):
    """A state tree of paged pools (fp8 content, bf16 rope, f32 scales,
    int32 tables) comes back byte for byte, onto the dtype of the tree it is
    loaded into, with the reference's dtype names in the manifest; ``keep``
    prunes to the newest checkpoints."""
    g = torch.Generator().manual_seed(0)
    pool = tkv.init_paged_mla_pool(tkv.CacheConfig(page_size=16), 3, 2, 2, 32, 8)
    pool = pool._replace(content=torch.randn(3, 16, 32, generator=g).to(torch.float8_e4m3fn),
                         rope=torch.randn(3, 16, 8, generator=g).to(torch.bfloat16),
                         scale=torch.rand(3, 16, generator=g))
    tree = {"layers": [pool, pool._replace(seq_lens=pool.seq_lens + 3)], "aux": None}
    for step in range(4):
        path = CK.save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    like = {"layers": [p._replace(content=torch.zeros_like(p.content)) for p in tree["layers"]],
            "aux": None}
    loaded, manifest = CK.load_checkpoint(path, like)
    assert {e["dtype"] for e in manifest["leaves"]} == {"float8_e4m3fn", "bfloat16", "float32",
                                                        "int32"}
    assert isinstance(loaded["layers"][1], tkv.PagedMLAPool) and loaded["aux"] is None
    for (pa, a), (pb, b) in zip(CK.flatten(tree), CK.flatten(loaded)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
    with pytest.raises(ValueError, match="leaves"):
        CK.load_checkpoint(path, {"layers": [pool]})


# ---------------------------------------------------------------------------
# the fault-tolerance runtime
# ---------------------------------------------------------------------------

def test_run_with_restarts_retries_then_succeeds():
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("simulated node failure")
        return "done"

    restarts = []
    assert tft.run_with_restarts(flaky, tft.RestartPolicy(max_restarts=5),
                                 on_restart=restarts.append) == "done"
    assert len(restarts) == 2


def test_run_with_restarts_exhausts_budget():
    def always_fails():
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        tft.run_with_restarts(always_fails, tft.RestartPolicy(max_restarts=2))


def test_preemption_handler_reset_and_restore():
    h = tft.PreemptionHandler(install=True)
    h.trigger()
    assert h.requested
    h.reset()
    assert not h.requested
    h._prev[signal.SIGTERM] = None
    h.restore()
    assert h._prev == {}
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)


def test_restart_policy_backoff_and_jitter_match_reference():
    p = tft.RestartPolicy(max_restarts=5, backoff_s=1.0, backoff_factor=2.0,
                          max_backoff_s=5.0)
    assert [p.delay(i) for i in (1, 2, 3, 4)] == [1.0, 2.0, 4.0, 5.0]
    assert tft.RestartPolicy().delay(3) == 0.0
    da, db, dj = ([p.delay(1) for _ in range(4)] for p in (
        tft.RestartPolicy(backoff_s=1.0, jitter=0.5, seed=0),
        tft.RestartPolicy(backoff_s=1.0, jitter=0.5, seed=0),
        jft.RestartPolicy(backoff_s=1.0, jitter=0.5, seed=0)))
    assert da == db == dj                 # seeded, and the reference's draws
    assert all(0.5 <= d <= 1.0 for d in da) and len(set(da)) > 1


# ---------------------------------------------------------------------------
# the engine's snapshot / restore against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_smoke("mla-7b"), t_smoke("mla-7b")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, n=3, pages=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=pages * cfg.page_size, dtype=np.int32)
            for _ in range(n)]


def _reqs(sched, cfg, gen=8):
    return [sched.Request(rid=i, prompt=p.copy(), max_new=gen, arrival=float(i))
            for i, p in enumerate(_prompts(cfg))]


class _Pkg:
    """One package's engine pieces, so a test runs the same flow on both."""

    def __init__(self, port, model):
        jcfg, tcfg, jparams, tparams = model
        self.port = port
        self.cfg, self.params = (tcfg, tparams) if port else (jcfg, jparams)
        self.engine_mod = tengine if port else jengine
        self.sched = tsched if port else jsched
        self.faults = tfaults if port else jfaults
        self.ft = tft if port else jft
        self.ck = CK if port else JCK

    def engine(self, cfg=None, **kw):
        ecfg = self.engine_mod.EngineConfig(seed=0, **{"max_batch": 3, "max_pages_per_seq": 4,
                                                       **kw.pop("ecfg", {})})
        extra = {"device": "cpu"} if self.port else {}
        return self.engine_mod.ServingEngine(cfg or self.cfg, self.params, ecfg, **kw, **extra)


def _counters(m):
    return {k: m[k] for k in ("steps", "pages", "work", "fetch_work", "requeues")} | {
        "prefill": m["prefill"]["tokens_series"],
        "faults": {k: v for k, v in m["faults"].items() if k != "injected"}}


@pytest.fixture(scope="module")
def clean_run(model):
    out = []
    for port in (False, True):
        pkg = _Pkg(port, model)
        res = pkg.engine().run(_reqs(pkg.sched, pkg.cfg))
        assert all(r.status == "done" for r in res)
        out.append({r.rid: r.tokens for r in res})
    assert out[1] == out[0]
    return out[1]


def _midflight(pkg, path):
    e1 = pkg.engine()
    for r in sorted(_reqs(pkg.sched, pkg.cfg), key=lambda r: r.arrival):
        while e1.step_idx < r.arrival:
            e1.step()
        e1.submit(r)
    for _ in range(3):
        e1.step()
    ckpt = e1.snapshot(str(path))
    assert pkg.ck.latest_checkpoint(str(path)) == ckpt
    e2 = pkg.engine()
    e2.restore(ckpt)
    assert e2.step_idx == e1.step_idx
    assert e2.metrics()["faults"]["restores"] == 1
    while not e2.scheduler.drained:
        e2.step()
    done = sorted(e2.scheduler.finished, key=lambda r: r.rid)
    assert [r.status.value for r in done] == ["done"] * 3
    m = e2.metrics()
    assert m["pages"]["free"] == m["pages"]["capacity"]
    return {r.rid: [int(t) for t in r.out_tokens] for r in done}, m


def test_checkpoint_roundtrip_midflight(model, clean_run, tmp_path):
    """tests/test_chaos.py:284: a snapshot three steps into decoding, restored
    into a fresh engine, drains to the uninterrupted run's tokens."""
    j_tok, jm = _midflight(_Pkg(False, model), tmp_path / "jax")
    t_tok, tm = _midflight(_Pkg(True, model), tmp_path / "port")
    assert t_tok == j_tok == clean_run
    assert _counters(tm) == _counters(jm)


def _preempted(pkg, path):
    plan = pkg.faults.FaultPlan([pkg.faults.FaultEvent("preempt", 5)])
    handler = pkg.ft.PreemptionHandler(install=False)
    out, restarts = {}, []

    def attempt() -> str:
        handler.reset()
        engine = pkg.engine(fault_plan=plan, preemption=handler)
        latest = pkg.ck.latest_checkpoint(str(path))
        if latest:
            engine.restore(latest)
        out["engine"] = engine
        out["results"] = engine.run(_reqs(pkg.sched, pkg.cfg), ckpt_dir=str(path),
                                    ckpt_every=3)
        return "done"

    assert pkg.ft.run_with_restarts(attempt, pkg.ft.RestartPolicy(max_restarts=2),
                                    on_restart=restarts.append) == "done"
    assert restarts == [1]
    m = out["engine"].metrics()
    assert m["faults"]["preemptions"] == 1 and m["faults"]["restores"] == 1
    assert [r.status for r in out["results"]] == ["done"] * 3
    assert m["pages"]["free"] == m["pages"]["capacity"]
    return {r.rid: r.tokens for r in out["results"]}, m


def test_preemption_under_run_with_restarts(model, clean_run, tmp_path):
    """tests/test_chaos.py:314: an injected preemption at step 5 snapshots and
    raises ``EnginePreempted``; the restarted attempt restores the latest
    snapshot and finishes with the uninterrupted tokens."""
    j_tok, jm = _preempted(_Pkg(False, model), tmp_path / "jax")
    t_tok, tm = _preempted(_Pkg(True, model), tmp_path / "port")
    assert t_tok == j_tok == clean_run
    assert _counters(tm) == _counters(jm)


def test_checkpoint_keep_prunes_old_snapshots(model, tmp_path):
    """tests/test_chaos.py:349, in both packages: the same kept steps."""
    kept = []
    for port in (False, True):
        pkg = _Pkg(port, model)
        d = tmp_path / ("port" if port else "jax")
        engine = pkg.engine()
        for r in _reqs(pkg.sched, pkg.cfg):
            engine.submit(r)
        for _ in range(4):
            engine.step()
            engine.snapshot(str(d), keep=2)
        names = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert len(names) == 2
        assert pkg.ck.latest_checkpoint(str(d)).endswith(names[-1])
        kept.append(names)
    assert kept[1] == kept[0]


def _spec_roundtrip(pkg, path):
    S, gen = 24, 12
    rand = np.asarray(jax.random.randint(jax.random.PRNGKey(14), (1, S), 0,
                                         pkg.cfg.vocab_size, jax.numpy.int32))
    prompts = list(rand) + [np.asarray(([5, 9, 2, 7] * S)[:S], np.int32)]
    span = -(-(S + gen) // pkg.cfg.page_size)
    ecfg = {"max_batch": 2, "max_pages_per_seq": span, "spec_draft_len": 3}
    reqs = lambda: [pkg.sched.Request(rid=i, prompt=p, max_new=gen, arrival=0.0)
                    for i, p in enumerate(prompts)]
    want = {r.rid: r.tokens for r in pkg.engine(ecfg=dict(ecfg)).run(reqs())}
    eng1 = pkg.engine(ecfg=dict(ecfg))
    for req in reqs():
        eng1.submit(req)
    for _ in range(6):
        eng1.step()
    ckpt = eng1.snapshot(str(path))
    assert eng1.proposer.export_state(), "mid-run slots must exist"
    eng2 = pkg.engine(ecfg=dict(ecfg))
    eng2.restore(ckpt)
    assert eng2.proposer.export_state() == eng1.proposer.export_state()
    got = {r.rid: r.tokens for r in eng2.run([])}
    assert got == want
    m = eng2.metrics()
    assert m["pages"]["free"] == m["pages"]["capacity"]
    return got, eng1.proposer.export_state(), m


def test_engine_spec_checkpoint_roundtrip_carries_proposer_state(model, tmp_path):
    """tests/test_serving.py:658: the proposer's per-slot state rides the
    snapshot and the restored speculative engine finishes token-identical to
    an uninterrupted run; the proposer states and tokens equal JAX's."""
    j_tok, j_spec, jm = _spec_roundtrip(_Pkg(False, model), tmp_path / "jax")
    t_tok, t_spec, tm = _spec_roundtrip(_Pkg(True, model), tmp_path / "port")
    assert t_tok == j_tok and t_spec == j_spec
    assert _counters(tm) == _counters(jm)
    assert tm["speculative"] == jm["speculative"]
