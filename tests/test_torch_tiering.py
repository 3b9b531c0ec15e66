"""The port's host KV tier (``repro_torch/serving/tiering.py``, the pool page
moves of ``core/kvcache.py`` and the engine's tier hooks) against the JAX
package.

  * page moves: ``pool_read_page`` reads the bytes the reference's reads,
    and a page offloaded to the tier, taken back and written into another
    page is byte-identical to the original;
  * the tier's export: equal to the reference ``HostTier``'s for the same
    numpy payload (fp8, bf16, float32, int32), and each restores the
    other's;
  * the assertions of ``tests/test_prefix_cache.py:160``, ``:182`` and
    ``:197`` against the port's allocator and tier;
  * the engine on the smoke mla-7b with bridged weights against the JAX
    engine (its reference backend; its kernel backend in interpret mode for
    ``:360``) on the workloads of ``tests/test_prefix_cache.py:332``,
    ``:360``, ``:373`` and ``:409``: tokens and the deterministic counters
    (steps, pages, prefix cache and tier counts, work and fetch series)
    equal. The tier's payload bytes are not compared across the packages:
    the reference holds the layers as one stacked leaf where the port holds
    a list, and the two packages' float32 matmuls may round a pool scale
    apart in its last bit (ROADMAP queue 3).
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import kvcache as jkv
from repro.models import transformer as JT
from repro.serving import allocator as jalloc
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro.serving import tiering as jtier
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import kvcache as tkv
from repro_torch.serving import allocator as talloc
from repro_torch.serving import engine as tengine
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import tiering as ttier

PAGE = 16


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_smoke("mla-7b"), t_smoke("mla-7b")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# page moves and the tier's bytes
# ---------------------------------------------------------------------------

def _random_pool(seed, n_pages=5, d_c=32, d_r=8):
    """A reference pool with random fp8 / bf16 / f32 bytes, and its port twin."""
    rng = np.random.default_rng(seed)
    jpool = jkv.init_paged_mla_pool(jkv.CacheConfig(page_size=PAGE), n_pages, 2, 1, d_c, d_r)
    jpool = jpool._replace(
        content=rng.normal(size=(n_pages, PAGE, d_c)).astype(ml_dtypes.float8_e4m3fn),
        rope=rng.normal(size=(n_pages, PAGE, d_r)).astype(ml_dtypes.bfloat16),
        scale=rng.random((n_pages, PAGE)).astype(np.float32))
    return jpool, bridge.pool_from_jax(jax.tree.map(np.asarray, jpool))


def _raw(t):
    return bridge.to_torch(np.asarray(t)).view(torch.uint8) if not isinstance(t, torch.Tensor) \
        else t.contiguous().view(torch.uint8)


def test_pool_page_moves_are_byte_identical():
    jpool, pool = _random_pool(0)
    for pid in (0, 3):
        for a, b in zip(jkv.pool_read_page(jpool, pid), tkv.pool_read_page(pool, pid)):
            assert torch.equal(_raw(a), _raw(b))
    tier = ttier.HostTier(2, device="cpu")
    slot = tier.alloc_slot()
    before = [t.clone() for t in tkv.pool_read_page(pool, 3)]
    tier.store(slot, [tkv.pool_read_page(pool, 3)])
    pool.content[3].zero_()                      # the page id is reused
    tkv.pool_write_page(pool, 1, tier.take(slot)[0])
    for a, b in zip(before, tkv.pool_read_page(pool, 1)):
        assert torch.equal(_raw(a), _raw(b))
    assert tier.num_used == 0 and tier.restores == 1


def _np_payload(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(PAGE, 8)).astype(ml_dtypes.float8_e4m3fn),
             rng.normal(size=(PAGE, 4)).astype(ml_dtypes.bfloat16),
             rng.random(PAGE).astype(np.float32)),
            (np.arange(6, dtype=np.int32).reshape(2, 3),)]


def test_tier_export_equals_reference_and_restores_either_way():
    """The same numpy payloads through both tiers (the same slot decisions):
    the exports are equal, and each tier restores the other's export to an
    equal one."""
    tiers = (jtier.HostTier(4), ttier.HostTier(4, device="cpu"))
    for seed in range(3):
        for tier in tiers:
            slot = tier.alloc_slot()
            payload = _np_payload(seed)
            if isinstance(tier, ttier.HostTier):
                payload = [tuple(bridge.to_torch(a) for a in leaf) for leaf in payload]
            tier.store(slot, payload)
    for tier in tiers:
        tier.prefetch(1)
        tier.take(1)
        tier.drop(0)
    j_state, t_state = (t.export_state() for t in tiers)
    assert t_state == j_state
    j2, t2 = jtier.HostTier(4), ttier.HostTier(4, device="cpu")
    j2.restore_state(t_state)
    t2.restore_state(j_state)
    assert j2.export_state() == t2.export_state() == j_state
    got = t2.take(2)
    want = _np_payload(2)
    for leaf, want_leaf in zip(got, want):
        for t, a in zip(leaf, want_leaf):
            assert t.dtype == bridge.to_torch(a).dtype
            assert torch.equal(_raw(t), _raw(a))


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py's tier contracts, against the port's classes
# ---------------------------------------------------------------------------

def _prompt(rng, n):
    return rng.integers(0, 1000, size=n, dtype=np.int32)


def _payload(pid: int) -> list[tuple]:
    return [(torch.full((2,), pid, dtype=torch.int32),)]


def _drain(a, tier) -> None:
    for kind, pid, slot in a.take_pending_tier_ops():
        if kind == "offload":
            tier.store(slot, _payload(pid))
        else:
            tier.take(slot)


def _alloc(a, prompt):
    pages = a.alloc_prompt(prompt)
    if pages is not None:
        a.mark_ready(pages, len(prompt))
    return pages


def test_offload_then_restore_roundtrip():
    tier = ttier.HostTier(4, device="cpu")
    a = talloc.PageAllocator(16, PAGE, prefix_cache_pages=1, host_tier=tier)
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, 2 * PAGE)
    a.free(_alloc(a, prompt))
    a.check_invariants()
    _drain(a, tier)
    a.check_invariants()
    assert a.num_cached == 1 and tier.num_used == 1 and tier.offloads == 1
    hit = _alloc(a, prompt.copy())
    assert hit.cached_tokens == 2 * PAGE
    assert hit.reused_pages == 1 and hit.restored_pages == 1
    assert a.has_pending_tier_ops
    a.check_invariants()
    _drain(a, tier)
    a.check_invariants()
    assert tier.restores == 1 and tier.num_used == 0
    a.free(hit)


def test_host_tier_full_drops_lru_host_page():
    tier = ttier.HostTier(1, device="cpu")
    a = talloc.PageAllocator(32, PAGE, prefix_cache_pages=1, host_tier=tier)
    rng = np.random.default_rng(5)
    for _ in range(3):
        a.free(_alloc(a, _prompt(rng, 2 * PAGE)))
        a.check_invariants()
        _drain(a, tier)
        a.check_invariants()
    assert tier.num_used == 1
    assert a.num_free + a.num_cached == a.capacity


def test_export_raises_with_pending_ops_and_roundtrips_after_drain():
    tier = ttier.HostTier(4, device="cpu")
    a = talloc.PageAllocator(16, PAGE, prefix_cache_pages=1, host_tier=tier)
    rng = np.random.default_rng(6)
    a.free(_alloc(a, _prompt(rng, 2 * PAGE)))
    assert a.has_pending_tier_ops
    with pytest.raises(RuntimeError, match="pending"):
        a.export_state()
    _drain(a, tier)
    state = a.export_state()
    tier2 = ttier.HostTier(4, device="cpu")
    tier2.restore_state(tier.export_state())
    b = talloc.PageAllocator(16, PAGE, prefix_cache_pages=1, host_tier=tier2)
    b.restore_state(state)
    assert b.export_state() == state
    assert tier2.export_state() == tier.export_state()
    with pytest.raises(ValueError, match="geometry"):
        ttier.HostTier(5, device="cpu").restore_state(tier.export_state())


def test_allocator_slot_decisions_match_reference():
    """The same offload / restore sequence through both allocators with
    their own tiers: the pending tier ops and the exported states equal."""
    logs = []
    for amod, tmod, mk in ((jalloc, jtier, lambda pid: [(np.full((2,), pid, np.int32),)]),
                           (talloc, ttier, _payload)):
        tier = tmod.HostTier(2) if tmod is jtier else tmod.HostTier(2, device="cpu")
        a = amod.PageAllocator(24, PAGE, prefix_cache_pages=2, host_tier=tier)
        rng = np.random.default_rng(9)
        prompts = [_prompt(rng, 3 * PAGE) for _ in range(3)]
        log = []
        for i in range(8):
            pages = _alloc(a, prompts[i % 3].copy())
            ops = a.take_pending_tier_ops()
            log.append((list(pages), pages.cached_tokens, ops))
            for kind, pid, slot in ops:
                tier.store(slot, mk(pid)) if kind == "offload" else tier.take(slot)
            a.free(pages)
            ops = a.take_pending_tier_ops()
            log.append(ops)
            for kind, pid, slot in ops:
                tier.store(slot, mk(pid)) if kind == "offload" else tier.take(slot)
            a.check_invariants()
        st = tier.export_state()
        log.append((a.export_state(), st["free"], st["offloads"], st["restores"]))
        logs.append(log)
    assert logs[1] == logs[0]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _shared_reqs(sched, cfg, seed, n, gap, gen):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, size=2 * PAGE, dtype=np.int32)
    return [sched.Request(rid=i, prompt=np.concatenate([
        shared, rng.integers(0, cfg.vocab_size, size=PAGE // 2, dtype=np.int32)]),
        max_new=gen, arrival=float(i * gap)) for i in range(n)]


def _ecfg(mod, span, **kw):
    return mod.EngineConfig(max_batch=2, max_pages_per_seq=span, n_pages=2 * span + 1,
                            seed=0, **kw)


def _engine(port, model, span, backend=None, **kw):
    jcfg, tcfg, jparams, tparams = model
    cfg = dataclasses.replace(tcfg if port else jcfg, prefill_chunk=PAGE)
    if backend is not None:
        cfg = dataclasses.replace(cfg, decode_backend=backend, use_kernels=backend == "kernel")
    mod = tengine if port else jengine
    extra = {"device": "cpu"} if port else {}
    return mod.ServingEngine(cfg, tparams if port else jparams, _ecfg(mod, span, **kw),
                             **extra)


def _run(port, model, seed, n, gap, gen, *, backend=None, **kw):
    sched = tsched if port else jsched
    reqs = _shared_reqs(sched, model[0], seed, n, gap, gen)
    span = (len(reqs[0].prompt) + gen + PAGE - 1) // PAGE
    eng = _engine(port, model, span, backend, **kw)
    res = eng.run(reqs)
    return eng, {r.rid: (r.status, r.tokens) for r in res}


def _counters(m):
    return {k: m[k] for k in ("steps", "pages", "prefix_cache", "work", "fetch_work",
                              "requeues", "evictions")} | {
        "prefill": m["prefill"]["tokens_series"],
        "faults": {k: v for k, v in m["faults"].items() if k != "injected"}}


@pytest.mark.parametrize("cache,tier", [(0, 0), (12, 0), (1, 8)],
                         ids=["cold", "cached", "tiered"])
def test_engine_cache_hit_matches_jax(model, cache, tier):
    """tests/test_prefix_cache.py:332: three requests sharing a 2-page prefix,
    arrivals 24 steps apart; the cold, the cached and the tiered runs each
    equal the JAX engine's, and all three give the cold tokens."""
    gen = 6
    j_eng, j_res = _run(False, model, 21, 3, 24, gen, prefix_cache_pages=cache,
                        host_tier_pages=tier)
    t_eng, t_res = _run(True, model, 21, 3, 24, gen, prefix_cache_pages=cache,
                        host_tier_pages=tier)
    assert t_res == j_res
    tm = t_eng.metrics()
    assert _counters(tm) == _counters(j_eng.metrics())
    _, cold = _run(True, model, 21, 3, 24, gen)
    assert t_res == cold
    assert tm["pages"]["free"] + tm["pages"]["cached"] == tm["pages"]["capacity"]
    if tier:
        assert tm["prefix_cache"]["restored_host"] > 0
        j_tier, t_tier = j_eng.tier.export_state(), t_eng.tier.export_state()
        assert {k: v for k, v in t_tier.items() if k != "data"} == \
            {k: v for k, v in j_tier.items() if k != "data"}
        assert t_eng.telemetry() == j_eng.telemetry()
    elif cache:
        assert tm["prefix_cache"]["prefill_skipped_tokens"] > 0


def test_engine_cache_hit_kernel_backend_matches_jax(model):
    """tests/test_prefix_cache.py:360: the same pin on the kernel backend (the
    JAX engine's Pallas kernels in interpret mode, the port's plain versions
    of its kernels), the tier round-tripping real fp8 payloads."""
    gen = 4
    j_eng, j_res = _run(False, model, 22, 2, 24, gen, backend="kernel", prefix_cache_pages=1,
                        host_tier_pages=8)
    t_eng, t_res = _run(True, model, 22, 2, 24, gen, backend="kernel", prefix_cache_pages=1,
                        host_tier_pages=8)
    _, cold = _run(True, model, 22, 2, 24, gen, backend="kernel")
    assert t_res == j_res == cold
    assert _counters(t_eng.metrics()) == _counters(j_eng.metrics())
    assert t_eng.metrics()["prefix_cache"]["restored_host"] > 0


def _tier_ckpt_run(port, model, path):
    """tests/test_prefix_cache.py:373's flow: a warm run parks pages in the
    host tier, a snapshot, a fresh engine restores it and serves the
    follow-up request through a host restore; its cold twin."""
    sched = tsched if port else jsched
    gen = 4
    warm = _shared_reqs(sched, model[0], 23, 1, 1, gen)
    nxt = lambda: dataclasses.replace(_shared_reqs(sched, model[0], 23, 2, 24, gen)[1],
                                      arrival=0.0)
    span = (len(warm[0].prompt) + gen + PAGE - 1) // PAGE
    e1 = _engine(port, model, span, prefix_cache_pages=1, host_tier_pages=8)
    e1.run(warm)
    assert e1.tier.num_used > 0
    ckpt = e1.snapshot(str(path))
    e2 = _engine(port, model, span, prefix_cache_pages=1, host_tier_pages=8)
    e2.restore(ckpt)
    assert e2.allocator.export_state() == e1.allocator.export_state()
    assert e2.tier.export_state() == e1.tier.export_state()
    results = {r.rid: r.tokens for r in e2.run([nxt()])}
    cold = {r.rid: r.tokens for r in _engine(port, model, span).run([nxt()])}
    assert results[1] == cold[1]
    return results, e2.metrics()


def test_engine_checkpoint_roundtrips_populated_host_tier(model, tmp_path):
    j_res, jm = _tier_ckpt_run(False, model, tmp_path / "jax")
    t_res, tm = _tier_ckpt_run(True, model, tmp_path / "port")
    assert t_res == j_res
    assert tm["prefix_cache"]["restored_host"] > 0
    assert _counters(tm) == _counters(jm)


def test_engine_restore_rejects_tier_checkpoint_without_tier(model, tmp_path):
    """tests/test_prefix_cache.py:409, in both packages."""
    for port, sub in ((False, "jax"), (True, "port")):
        sched = tsched if port else jsched
        ecfg_kw = dict(prefix_cache_pages=1, host_tier_pages=4)
        e1 = _engine(port, model, 4, **ecfg_kw)
        e1.run(_shared_reqs(sched, model[0], 24, 1, 1, 4))
        assert e1.tier.num_used > 0
        path = e1.snapshot(str(tmp_path / sub))
        e2 = _engine(port, model, 4)
        with pytest.raises(ValueError, match="host"):
            e2.restore(path)
