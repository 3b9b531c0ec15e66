"""Port MLA layer math and the paged pool against the JAX reference: layers,
projections and prefill attention within 1e-5; paged prefill / append give
identical pool bytes (capacity clamp and ``active`` gate included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.core import mla as jmla
from repro.models import layers as jL
from repro_torch import bridge
from repro_torch.core import kvcache as tkv
from repro_torch.core import mla as tmla
from repro_torch.models import layers as tL

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(d_model=64, n_heads=4, d_head=16, d_rope=16, d_c=32)   # mla-7b smoke


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _params():
    jp = jmla.init_mla_params(jax.random.PRNGKey(0), jmla.MLAConfig(**CFG))
    np_p = jax.tree.map(np.asarray, jp)
    return jp, bridge.mla_params_from_jax(np_p)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_layers_match():
    x, g = _np(1, (3, 5, 64)), _np(2, (64,))
    _close(tL.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jax.jit(jL.rms_norm)(x, g))
    pos = np.arange(12, dtype=np.int32)
    ts, tc = tL.rope_freqs(torch.from_numpy(pos), 16)
    js, jc = jL.rope_freqs(pos, 16)
    _close(ts, js)
    _close(tc, jc)
    xr = _np(3, (12, 4, 16))
    _close(tL.apply_rope(torch.from_numpy(xr), ts[:, None], tc[:, None]),
           jL.apply_rope(xr, js[:, None], jc[:, None]))
    jm = jL.init_mlp_params(jax.random.PRNGKey(3), 64, 128)
    tm = tL.MLPParams(*(bridge.to_torch(np.asarray(w)) for w in jm))
    _close(tL.mlp(tm, torch.from_numpy(x)), jax.jit(jL.mlp)(jm, x))
    table = _np(4, (256, 64), 0.02)
    toks = np.array([[1, 7, 255], [0, 3, 3]], np.int32)
    _close(tL.embed(torch.from_numpy(table), torch.from_numpy(toks)),
           jL.embed(table, toks))


def test_projections_match():
    jp, tp = _params()
    cfg_j, cfg_t = jmla.MLAConfig(**CFG), tmla.MLAConfig(**CFG)
    assert cfg_t.softmax_scale == cfg_j.softmax_scale
    h = _np(5, (2, 7, 64))
    pos = np.arange(7, dtype=np.int32) + 3
    th, tpos = torch.from_numpy(h), torch.from_numpy(pos)
    jq_c, jq_r = jmla.project_q(jp, cfg_j, h, pos)
    tq_c, tq_r = tmla.project_q(tp, cfg_t, th, tpos)
    _close(tq_c, jq_c)
    _close(tq_r, jq_r)
    jc, jr = jmla.project_kv(jp, cfg_j, h, pos)
    tc, tr = tmla.project_kv(tp, cfg_t, th, tpos)
    _close(tc, jc)
    _close(tr, jr)
    _close(tmla.absorb_q(tp, tq_c), jmla.absorb_q(jp, jq_c))
    o_lat = _np(6, (2, 4, 32))
    _close(tmla.output_proj(tp, torch.from_numpy(o_lat)), jmla.output_proj(jp, o_lat))


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches(causal):
    jp, tp = _params()
    h = _np(7, (2, 9, 64))
    pos = np.arange(9, dtype=np.int32)
    _close(tmla.mla_attention(tp, tmla.MLAConfig(**CFG), torch.from_numpy(h),
                              torch.from_numpy(pos), causal=causal),
           jax.jit(lambda *a: jmla.mla_attention(*a, causal=causal), static_argnums=1)(
               jp, jmla.MLAConfig(**CFG), h, pos))


def _pool_bytes(pool):
    """(content, rope, scale, seq_lens) raw bytes of a port or JAX pool."""
    out = []
    for name in ("content", "rope", "scale", "page_table", "seq_lens"):
        x = getattr(pool, name)
        if isinstance(x, torch.Tensor):
            x = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else (
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
            out.append(x.numpy())
        else:
            a = np.asarray(x)
            out.append(a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else (
                a.view(np.int16) if a.dtype.name == "bfloat16" else a))
    return out


def _assert_pools_equal(tp, jp):
    for t, j in zip(_pool_bytes(tp), _pool_bytes(jp)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_paged_prefill_and_append_identical_bytes(fmt):
    """Shuffled page table, a prefill that ends mid-page, appends that cross
    a page boundary, an ``active`` gate, and appends past capacity (clamped
    to the final slot)."""
    B, page, P, d_c, d_r = 3, 16, 3, 32, 16
    jcfg, tcfg = jkv.CacheConfig(fmt=fmt, page_size=page), tkv.CacheConfig(
        fmt=fmt, page_size=page)
    table = np.random.RandomState(0).permutation(B * P + 2)[: B * P].reshape(B, P)
    jpool = jkv.init_paged_mla_pool(jcfg, B * P + 2, P, B, d_c, d_r)._replace(
        page_table=jnp.asarray(table, jnp.int32))
    tpool = tkv.init_paged_mla_pool(tcfg, B * P + 2, P, B, d_c, d_r)._replace(
        page_table=torch.from_numpy(table.astype(np.int32)))
    S = 30
    c, r = _np(8, (B, S, d_c), 2.0), _np(9, (B, S, d_r), 25.0)
    jpool = jax.jit(jkv.paged_mla_prefill, static_argnums=1)(jpool, jcfg, c, r)
    tpool = tkv.paged_mla_prefill(tpool, tcfg, torch.from_numpy(c), torch.from_numpy(r))
    _assert_pools_equal(tpool, jpool)
    append = jax.jit(jkv.paged_mla_append, static_argnums=1)
    rs = np.random.RandomState(10)
    for step in range(22):                     # 30 + 22 > capacity 48: clamp
        cn, rn = _np(100 + step, (B, d_c), 2.0), _np(200 + step, (B, d_r), 25.0)
        active = rs.rand(B) > 0.3 if step % 3 == 1 else None
        jpool = append(jpool, jcfg, cn, rn, None if active is None
                       else jnp.asarray(active))
        tpool = tkv.paged_mla_append(tpool, tcfg, torch.from_numpy(cn),
                                     torch.from_numpy(rn), None if active is None
                                     else torch.from_numpy(active))
        _assert_pools_equal(tpool, jpool)
    assert int(tpool.seq_lens.max()) > tpool.capacity


def test_batch_owned_pool_layout_and_gather():
    tcfg = tkv.CacheConfig(fmt="fp8_e4m3", page_size=16)
    jcfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=16)
    assert tkv.page_aligned_capacity(33, 16) == jkv.page_aligned_capacity(33, 16)
    tpool = tkv.init_paged_mla_cache(tcfg, 2, 33, 32, 16)
    jpool = jkv.init_paged_mla_cache(jcfg, 2, 33, 32, 16)
    _assert_pools_equal(tpool, jpool)
    assert tpool.capacity == jpool.capacity and tpool.page_size == jpool.page_size
    c, r = _np(11, (2, 20, 32)), _np(12, (2, 20, 16))
    tpool = tkv.paged_mla_prefill(tpool, tcfg, torch.from_numpy(c), torch.from_numpy(r))
    jpool = jax.jit(jkv.paged_mla_prefill, static_argnums=1)(jpool, jcfg, c, r)
    for t, j in zip(tkv.paged_gather(tpool), jkv.paged_gather(jpool)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j).astype(np.float32))
