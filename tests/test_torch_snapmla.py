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
                               use_kernel=use_kernel, num_splits=num_splits)
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

