"""Port single-layer SnapMLA (core.snapmla, paged pool) against the JAX
``decode_step`` on the same weights and the same pool bytes, for fp8, int8
and none. The JAX side runs jitted with its Pallas kernels in interpret mode;
the port runs its kernel wrappers (plain versions on CPU tensors) and its
reference backend."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.core import mla as jmla
from repro.core import snapmla as jsnap
from repro_torch import bridge
from repro_torch.core import kvcache as tkv
from repro_torch.core import mla as tmla
from repro_torch.core import snapmla as tsnap

DIMS = dict(d_model=64, n_heads=4, d_head=16, d_rope=16, d_c=32)   # mla-7b smoke
B, S, MAX_LEN, PAGE = 3, 21, 64, 16
# the decode kernels' gate (tests/test_paged_splitkv.py:73-81)
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(fmt, num_splits, use_kernel):
    jcfg = jsnap.SnapMLAConfig(mla=jmla.MLAConfig(**DIMS),
                               cache=jkv.CacheConfig(fmt=fmt, page_size=PAGE),
                               use_kernel=use_kernel, interpret=True,
                               num_splits=num_splits, paged=True)
    tcfg = tsnap.SnapMLAConfig(mla=tmla.MLAConfig(**DIMS),
                               cache=tkv.CacheConfig(fmt=fmt, page_size=PAGE),
                               use_kernel=use_kernel, num_splits=num_splits, paged=True)
    return jcfg, tcfg


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("num_splits", [1, 2])
def test_paged_decode_step_matches_jax(fmt, num_splits):
    jcfg, tcfg = _configs(fmt, num_splits, use_kernel=True)
    jp = jmla.init_mla_params(jax.random.PRNGKey(0), jcfg.mla)
    tp = bridge.mla_params_from_jax(jax.tree.map(np.asarray, jp))
    rs = np.random.RandomState(1)
    h = rs.standard_normal((B, S, DIMS["d_model"])).astype(np.float32)
    out_j, pool_j = jax.jit(jsnap.prefill, static_argnums=1)(
        jp, jcfg, h, jsnap.init_cache(jcfg, B, MAX_LEN))
    out_t, pool_t = tsnap.prefill(tp, tcfg, torch.from_numpy(h),
                                  tsnap.init_cache(tcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    # decode from the SAME quantized bytes
    pool_t = bridge.pool_from_jax(jax.tree.map(np.asarray, pool_j))
    step_j = jax.jit(jsnap.decode_step, static_argnums=1)
    ref_cfg = dataclasses.replace(tcfg, use_kernel=False)
    for i in range(3):
        h_t = rs.standard_normal((B, DIMS["d_model"])).astype(np.float32)
        pool_copy = tkv.PagedMLAPool(*(x.clone() for x in pool_t))
        y_j, pool_j = step_j(jp, jcfg, h_t, pool_j)
        y_t, pool_next = tsnap.decode_step(tp, tcfg, torch.from_numpy(h_t), pool_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
        assert pool_next.seq_lens.tolist() == np.asarray(pool_j.seq_lens).tolist()
        # the reference backend (the pool is updated in place: run it on a copy)
        y_r, _ = tsnap.decode_step(tp, ref_cfg, torch.from_numpy(h_t), pool_copy)
        np.testing.assert_allclose(y_r.numpy(), y_t.numpy(), **TOL)
        pool_t = bridge.pool_from_jax(jax.tree.map(np.asarray, pool_j))



@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("num_splits,rescale", [(1, "fma"), (2, "fma"), (2, "amla")])
def test_contiguous_decode_step_matches_jax(fmt, num_splits, rescale):
    """The contiguous branch: Fused-K-Append (quantized) or the append
    ("none"), then the contiguous kernels' plain versions; the cache after
    each step is byte-identical to JAX's."""
    jcfg, tcfg = _configs(fmt, num_splits, use_kernel=True)
    jcfg = dataclasses.replace(jcfg, paged=False, rescale=rescale,
                               cache=dataclasses.replace(jcfg.cache, sink_tokens=4))
    tcfg = dataclasses.replace(tcfg, paged=False, rescale=rescale,
                               cache=dataclasses.replace(tcfg.cache, sink_tokens=4))
    jp = jmla.init_mla_params(jax.random.PRNGKey(0), jcfg.mla)
    tp = bridge.mla_params_from_jax(jax.tree.map(np.asarray, jp))
    rs = np.random.RandomState(2)
    h = rs.standard_normal((B, S, DIMS["d_model"])).astype(np.float32)
    _, cache_j = jax.jit(jsnap.prefill, static_argnums=1)(
        jp, jcfg, h, jsnap.init_cache(jcfg, B, MAX_LEN))
    cache_t = bridge.cache_from_jax(jax.tree.map(np.asarray, cache_j))
    step_j = jax.jit(jsnap.decode_step, static_argnums=1)
    o_tol = dict(rtol=0, atol=1e-4) if rescale == "amla" else TOL
    for _ in range(3):
        h_t = rs.standard_normal((B, DIMS["d_model"])).astype(np.float32)
        y_j, cache_j = step_j(jp, jcfg, h_t, cache_j)
        y_t, cache_t = tsnap.decode_step(tp, tcfg, torch.from_numpy(h_t), cache_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **o_tol)
        want = bridge.cache_from_jax(jax.tree.map(np.asarray, cache_j))
        assert cache_t.seq_lens.tolist() == want.seq_lens.tolist()
        # the new row holds each side's own projection of h_t: equal up to
        # float rounding (its quantized bytes are held exactly, for the same
        # inputs, in test_torch_contiguous.py); every other row is untouched
        rows = torch.arange(B)
        new = cache_t.seq_lens.long() - 1
        np.testing.assert_allclose(cache_t.scale[rows, new].numpy(),
                                   want.scale[rows, new].numpy(), rtol=1e-5)
        np.testing.assert_allclose(cache_t.sink.numpy(), want.sink.numpy(), rtol=1e-5,
                                   atol=1e-6)
        codes = (cache_t.content[rows, new].float() == want.content[rows, new].float())
        assert float(codes.float().mean()) > 0.9
        for x in (cache_t.content, cache_t.rope, cache_t.scale):
            x[rows, new] = 0
        for x in (want.content, want.rope, want.scale):
            x[rows, new] = 0
        for a, b in zip(cache_t[:3], want[:3]):
            assert torch.equal(a.float(), b.float())
        cache_t = bridge.cache_from_jax(jax.tree.map(np.asarray, cache_j))


def test_contiguous_init_and_prefill_match_jax():
    jcfg, tcfg = _configs("fp8_e4m3", 1, use_kernel=True)
    jcfg = dataclasses.replace(jcfg, paged=False)
    tcfg = dataclasses.replace(tcfg, paged=False)
    jp = jmla.init_mla_params(jax.random.PRNGKey(1), jcfg.mla)
    tp = bridge.mla_params_from_jax(jax.tree.map(np.asarray, jp))
    h = np.random.RandomState(3).standard_normal((B, S, DIMS["d_model"])).astype(np.float32)
    out_j, cache_j = jax.jit(jsnap.prefill, static_argnums=1)(
        jp, jcfg, h, jsnap.init_cache(jcfg, B, MAX_LEN))
    out_t, cache_t = tsnap.prefill(tp, tcfg, torch.from_numpy(h),
                                   tsnap.init_cache(tcfg, B, MAX_LEN, device="cpu"))
    assert isinstance(cache_t, tkv.MLACache)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    # the latents come from the port's own projection: scales and rope match
    # to float rounding, the stored codes mostly bit for bit
    np.testing.assert_allclose(cache_t.scale.numpy(), np.asarray(cache_j.scale), rtol=1e-5)
    assert cache_t.seq_lens.tolist() == np.asarray(cache_j.seq_lens).tolist()
