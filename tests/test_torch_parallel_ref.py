"""The parallel (einsum) decode forms of the port against the JAX package's,
on the SAME quantized cache bytes carried over by ``repro_torch.bridge``, at
the reference tests' stress scale (content x2, rope x25, q_r x5):

  * ``snapmla_decode_parallel_ref`` within tests/test_kernels_mla_decode.py:
    69-81's tolerance (o rtol 1e-4 / atol 1e-5, lse 1e-5);
  * the split-parallel form on ragged lengths (empty rows included) and
    ``snapmla_decode_parallel_any`` at rank 3 and rank 4, lse within
    tests/test_splitkv.py:147's (rtol 1e-5, atol 1e-4);
  * the GQA parallel form (tests/test_kernels_gqa_decode.py:72's shapes);
  * ``torch_ref`` / ``torch_paged_ref`` and ``_attn_decode`` under a ``ref``
    backend decode through them, as the reference's ``jnp_ref`` /
    ``jnp_paged_ref`` and GQA model path do;
  * ``core.mla.mla_decode_absorbed`` (tests/test_mla.py:30's 2e-4).

The JAX side runs jitted, as the reference's model paths run it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.core import mla as jmla
from repro.kernels.gqa_decode import ref as JGR
from repro.kernels.mla_decode import backends as JB
from repro.kernels.mla_decode import ref as JR
from repro_torch import bridge
from repro_torch.core import kvcache as tkv
from repro_torch.core import mla as tmla
from repro_torch.kernels.gqa_decode import ref as TGR
from repro_torch.kernels.mla_decode import autotune
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import ref as TR

SCALE = 0.1
O_TOL = dict(rtol=1e-4, atol=1e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_LSE_TOL = dict(rtol=1e-5, atol=1e-4)
RAGGED_LENS = [0, 20, 130, 192, 256]      # tests/test_splitkv.py:19


@pytest.fixture(autouse=True)
def _empty_profile():
    """Split plans from the heuristic, whatever profile the repo holds."""
    autotune.reset(autotune.SplitProfile())
    yield
    autotune.reset()


def _case(seed, B, S, N, d_c, d_r, fmt, page, H, lens=None, q_len=0):
    """A JAX-quantized contiguous cache at the stress scale and a prepared
    query ([B, H, .], or [B, q_len, H, .]), as JAX and as the port's."""
    rs = np.random.RandomState(seed)
    cfg = jkv.CacheConfig(fmt=fmt, page_size=page)
    c = (rs.standard_normal((B, S, d_c)) * 2).astype(np.float32)
    r = (rs.standard_normal((B, S, d_r)) * 25).astype(np.float32)
    cache = jax.jit(jkv.mla_prefill, static_argnums=1)(
        jkv.init_mla_cache(cfg, B, N, d_c, d_r), cfg, c, r)
    if lens is not None:
        cache = cache._replace(seq_lens=jnp.asarray(lens, jnp.int32))
    lead = (B, q_len, H) if q_len else (B, H)
    q_c = rs.standard_normal(lead + (d_c,)).astype(np.float32)
    q_r = (rs.standard_normal(lead + (d_r,)) * 5).astype(np.float32)
    q = jax.jit(JR.prepare_q, static_argnums=2)(q_c, q_r, fmt)
    j_args = tuple(q) + (cache.content, cache.rope.astype(jnp.float32), cache.scale,
                         cache.seq_lens)
    tc = bridge.cache_from_jax(jax.tree.map(np.asarray, cache))
    t_args = tuple(bridge.to_torch(np.asarray(x)) for x in q) + (
        tc.content, tc.rope.float(), tc.scale, tc.seq_lens)
    return cache, tc, j_args, t_args


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("B,H,d_c,d_r,S,N,bn", [
    (1, 4, 32, 16, 50, 64, 32),
    (2, 8, 64, 16, 200, 256, 64),
    (3, 16, 128, 32, 130, 256, 128),
])
def test_parallel_ref_matches_jax(fmt, B, H, d_c, d_r, S, N, bn):
    _, _, ja, ta = _case(B * 7 + H, B, S, N, d_c, d_r, fmt, bn, H)
    o_j, lse_j = jax.jit(lambda *a: JR.snapmla_decode_parallel_ref(
        *a, softmax_scale=SCALE, block_n=bn, fmt=fmt))(*ja)
    o_t, lse_t = TR.snapmla_decode_parallel_ref(*ta, softmax_scale=SCALE, block_n=bn, fmt=fmt)
    _close(o_t, o_j, O_TOL)
    _close(lse_t, lse_j, LSE_TOL)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "none"])
@pytest.mark.parametrize("num_splits", [2, 4])
def test_splitkv_parallel_ref_matches_jax_ragged(fmt, num_splits):
    """Empty rows emit the neutral (0, NEG_INF) partial on both sides."""
    B, N, bn = len(RAGGED_LENS), 256, 32
    _, _, ja, ta = _case(8, B, N, N, 32, 16, fmt, bn, 4, lens=RAGGED_LENS)
    kw = dict(softmax_scale=SCALE, num_splits=num_splits, block_n=bn, fmt=fmt)
    o_j, lse_j = jax.jit(lambda *a: JR.snapmla_decode_splitkv_parallel_ref(*a, **kw))(*ja)
    o_t, lse_t = TR.snapmla_decode_splitkv_parallel_ref(*ta, **kw)
    assert not torch.isnan(o_t).any()
    assert torch.all(lse_t[0] == TR.NEG_INF) and torch.all(o_t[0] == 0)
    _close(o_t, o_j, O_TOL)
    _close(lse_t, lse_j, SPLIT_LSE_TOL)


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("q_len", [0, 3])
def test_parallel_any_matches_jax(num_splits, q_len):
    """Rank 3 and rank 4 (the verify contract: row t decodes at
    ``seq_lens - (q_len - 1) + t``)."""
    lens = [40, 130, 200]
    _, _, ja, ta = _case(11, 3, 200, 256, 32, 16, "fp8_e4m3", 32, 4, lens=lens, q_len=q_len)
    kw = dict(softmax_scale=SCALE, num_splits=num_splits, block_n=32, fmt="fp8_e4m3")
    o_j, lse_j = jax.jit(lambda *a: JR.snapmla_decode_parallel_any(*a, **kw))(*ja)
    o_t, lse_t = TR.snapmla_decode_parallel_any(*ta, **kw)
    assert o_t.shape == tuple(o_j.shape)
    _close(o_t, o_j, O_TOL)
    _close(lse_t, lse_j, SPLIT_LSE_TOL)


@pytest.mark.parametrize("window", [0, 64])
def test_gqa_parallel_ref_matches_jax(window):
    B, S, N, Hkv, g, dh, bn = 2, 150, 192, 2, 4, 32, 64
    rs = np.random.RandomState(6 + window)
    cfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=bn, window=window)
    k = rs.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rs.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    cache = jax.jit(jkv.gqa_prefill, static_argnums=1)(
        jkv.init_gqa_cache(cfg, B, N, Hkv, dh), cfg, k, v)
    q = rs.standard_normal((B, Hkv * g, dh)).astype(np.float32)
    pos = np.full((B,), S - 1, np.int32)
    kw = dict(window=window, block_n=bn, fmt="fp8_e4m3")
    o_j = jax.jit(lambda *a: JGR.gqa_decode_parallel_ref(*a, **kw))(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.slot_pos, pos)
    tc = bridge.gqa_cache_from_jax(jax.tree.map(np.asarray, cache))
    o_t = TGR.gqa_decode_parallel_ref(torch.from_numpy(q), tc.k, tc.v, tc.k_scale,
                                      tc.v_scale, tc.slot_pos, torch.from_numpy(pos), **kw)
    _close(o_t, o_j, O_TOL)


@pytest.mark.parametrize("num_splits", [1, 2])
def test_ref_backends_decode_through_the_parallel_form(num_splits):
    """``torch_ref`` and ``torch_paged_ref`` give ``parallel_any``'s bits on
    the sink-patched content / the gathered pages, and agree with the
    reference's ``jnp_ref`` / ``jnp_paged_ref`` backends; ``rescale`` does
    nothing there."""
    lens = [20, 128, 65]
    jc, tc, ja, ta = _case(5, 3, 128, 128, 32, 16, "fp8_e4m3", 16, 4, lens=lens)
    cfg = TB.BackendConfig(softmax_scale=SCALE, block_n=16, num_splits=num_splits)
    dq = TB.DecodeQuery(*ta[:3])
    o = TB.get_backend("torch_ref").decode(dq, tc, cfg)
    want, _ = TR.snapmla_decode_parallel_any(*ta, softmax_scale=SCALE, num_splits=num_splits,
                                             block_n=16)
    assert torch.equal(o.view(torch.int32), want.view(torch.int32))
    o_amla = TB.get_backend("torch_ref").decode(dq, tc, dataclasses.replace(cfg, rescale="amla"))
    assert torch.equal(o_amla.view(torch.int32), o.view(torch.int32))
    jcfg = JB.BackendConfig(softmax_scale=SCALE, block_n=16, num_splits=num_splits)
    o_j = jax.jit(lambda q, c: JB.get_backend("jnp_ref").decode(q, c, jcfg))(
        JB.DecodeQuery(*ja[:3]), jc)
    _close(o, o_j, O_TOL)
    # the same blocks as a batch-owned page pool
    pcfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=16)
    rs = np.random.RandomState(1)
    c = (rs.standard_normal((3, 128, 32)) * 2).astype(np.float32)
    r = (rs.standard_normal((3, 128, 16)) * 25).astype(np.float32)
    jpool = jax.jit(jkv.paged_mla_prefill, static_argnums=1)(
        jkv.init_paged_mla_cache(pcfg, 3, 128, 32, 16), pcfg, c, r)
    jpool = jpool._replace(seq_lens=jnp.asarray(lens, jnp.int32))
    tpool = bridge.pool_from_jax(jax.tree.map(np.asarray, jpool))
    o_p = TB.get_backend("torch_paged_ref").decode(dq, tpool, cfg)
    gc, gr, gs = tkv.paged_gather(tpool)
    want_p, _ = TR.snapmla_decode_parallel_any(*ta[:3], gc, gr.float(), gs, tpool.seq_lens,
                                               softmax_scale=SCALE, num_splits=num_splits,
                                               block_n=16)
    assert torch.equal(o_p.view(torch.int32), want_p.view(torch.int32))
    o_pj = jax.jit(lambda q, p: JB.get_backend("jnp_paged_ref").decode(q, p, jcfg))(
        JB.DecodeQuery(*ja[:3]), jpool)
    _close(o_p, o_pj, O_TOL)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
def test_pipeline_backends_are_the_kernels_plain_version(rescale):
    """``torch_pipeline`` / ``torch_paged_pipeline`` give the bits of
    ``ops.snapmla_decode(..., use_kernel=False)`` (paged: ``_paged``), in
    either rescale mode; on CPU tensors the kernel backends give the same."""
    from repro_torch.kernels.mla_decode import ops as tops
    lens = [20, 128, 65]
    _, tc, _, ta = _case(9, 3, 128, 128, 32, 16, "fp8_e4m3", 16, 4, lens=lens)
    cfg = TB.BackendConfig(softmax_scale=SCALE, block_n=16, num_splits=2, rescale=rescale)
    dq = TB.DecodeQuery(*ta[:3])
    want, _ = tops.snapmla_decode(*ta[:3], tc, softmax_scale=SCALE, block_n=16, num_splits=2,
                                  use_kernel=False, rescale=rescale)
    for name in ("torch_pipeline", "cuda_splitkv"):
        o = TB.get_backend(name).decode(dq, tc, cfg)
        assert torch.equal(o.view(torch.int32), want.view(torch.int32)), name
    pool = tkv.init_paged_mla_cache(tkv.CacheConfig(fmt="fp8_e4m3", page_size=16), 3, 128,
                                    32, 16)
    for x, y in zip(pool[:3], (tc.content, tc.rope, tc.scale)):    # row b owns pages 8b..
        x.view(-1).copy_(y.reshape(-1))
    pool = pool._replace(seq_lens=tc.seq_lens)
    want_p, _ = tops.snapmla_decode_paged(*ta[:3], pool, softmax_scale=SCALE, num_splits=2,
                                          use_kernel=False, rescale=rescale)
    assert torch.equal(want_p.view(torch.int32), want.view(torch.int32))
    for name in ("torch_paged_pipeline", "cuda_paged_splitkv"):
        o = TB.get_backend(name).decode(dq, pool, cfg)
        assert torch.equal(o.view(torch.int32), want_p.view(torch.int32)), name


def test_attn_decode_under_ref_runs_the_gqa_parallel_form(monkeypatch):
    """Under ``ref`` a GQA layer decodes through ``gqa_decode_parallel_ref``
    (transformer.py:351); under ``kernel`` through #7's wrapper."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.gqa_decode import ops as GO
    from repro_torch.models import transformer as T
    calls = {"parallel": 0, "kernel": 0}
    parallel, kernel = TGR.gqa_decode_parallel_ref, GO.gqa_decode

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(TGR, "gqa_decode_parallel_ref", count("parallel", parallel))
    monkeypatch.setattr(GO, "gqa_decode", count("kernel", kernel))
    base = get_smoke_config("llama3.2-3b")
    gen = torch.Generator().manual_seed(0)
    params = T.init_model(gen, base, device="cpu")
    prompts = torch.randint(0, base.vocab_size, (2, 9), generator=gen)
    for backend in ("ref", "kernel"):
        cfg = dataclasses.replace(base, decode_backend=backend, use_kernels=backend == "kernel")
        state = T.init_decode_state(cfg, 2, 32, device="cpu")
        _, state = T.prefill(params, cfg, prompts, state)
        T.decode_step(params, cfg, prompts[:, -1], state, torch.full((2,), 9))
        if backend == "ref":
            assert calls == {"parallel": base.n_layers, "kernel": 0}
    assert calls == {"parallel": base.n_layers, "kernel": base.n_layers}


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_decode_absorbed_matches_jax(q_lora):
    cfg = dict(d_model=96, n_heads=4, d_head=24, d_rope=12, d_c=48, q_lora_rank=q_lora)
    jcfg, tcfg = jmla.MLAConfig(**cfg), tmla.MLAConfig(**cfg)
    jp = jmla.init_mla_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.mla_params_from_jax(jax.tree.map(np.asarray, jp))
    B, S = 2, 17
    h = np.random.RandomState(1).standard_normal((B, S, 96)).astype(np.float32)
    c_kv, k_r = jmla.project_kv(jp, jcfg, h, jnp.arange(S))
    lens, pos = np.full((B,), S, np.int32), np.full((B,), S - 1, np.int32)
    want = jmla.mla_decode_absorbed(jp, jcfg, h[:, -1], c_kv, k_r, lens, pos)
    got = tmla.mla_decode_absorbed(tp, tcfg, torch.from_numpy(h[:, -1]),
                                   torch.from_numpy(np.array(c_kv)),
                                   torch.from_numpy(np.array(k_r)),
                                   torch.from_numpy(lens), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # and it equals full attention's last row (tests/test_mla.py:16-33)
    full = tmla.mla_attention(tp, tcfg, torch.from_numpy(h), torch.arange(S))
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), rtol=2e-4, atol=2e-4)
