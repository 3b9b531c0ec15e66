"""The port's GQA cache (``init_gqa_cache``, ``gqa_append``, ``gqa_prefill``)
writes the bytes jitted JAX writes: codes, scales, ``slot_pos`` and
``seq_lens``, in the three formats, with and without a ring buffer, and under
the ``active`` gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro_torch import bridge
from repro_torch.core import kvcache as tkv

FMTS = ["fp8_e4m3", "int8", "none"]


def _bytes(x) -> np.ndarray:
    """Raw bytes of a JAX array (as numpy) or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else \
            x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def assert_same_cache(t: tkv.GQACache, j) -> None:
    for name in tkv.GQACache._fields:
        np.testing.assert_array_equal(_bytes(getattr(t, name)), _bytes(getattr(j, name)),
                                      err_msg=name)


def _kv(rng, B, S, Hkv, dh, scale=1.0):
    k = (rng.standard_normal((B, S, Hkv, dh)) * scale).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, dh)) * scale).astype(np.float32)
    return k, v


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("window,max_len,page", [(0, 40, 16), (32, 64, 16), (24, 100, 16)])
def test_init_and_prefill_bytes(fmt, window, max_len, page):
    B, Hkv, dh = 2, 2, 16
    jcfg = jkv.CacheConfig(fmt=fmt, page_size=page, window=window)
    tcfg = tkv.CacheConfig(fmt=fmt, page_size=page, window=window)
    j0 = jkv.init_gqa_cache(jcfg, B, max_len, Hkv, dh)
    t0 = tkv.init_gqa_cache(tcfg, B, max_len, Hkv, dh)
    assert t0.capacity == j0.capacity
    assert_same_cache(t0, j0)
    rng = np.random.default_rng([window, max_len])
    for S in (5, t0.capacity, 50 if window else t0.capacity - 3):
        k, v = _kv(rng, B, S, Hkv, dh, scale=3.0)
        k[0, 0] = 0.0                                       # the EPS floor
        j = jax.jit(lambda c, a, b: jkv.gqa_prefill(c, jcfg, a, b))(
            j0, jnp.asarray(k), jnp.asarray(v))
        t = tkv.gqa_prefill(tkv.init_gqa_cache(tcfg, B, max_len, Hkv, dh), tcfg,
                            torch.from_numpy(k), torch.from_numpy(v))
        assert_same_cache(t, j)


@pytest.mark.parametrize("fmt", FMTS)
def test_ring_append_wraps_and_matches_prefill(fmt):
    """S 50 tokens one by one into a window-32 ring (page 16), as
    test_ring_buffer_append_matches_prefill: every step's bytes equal jitted
    JAX, and the result equals a bulk prefill."""
    B, Hkv, dh, window, S = 1, 2, 16, 32, 50
    jcfg = jkv.CacheConfig(fmt=fmt, page_size=16, window=window)
    tcfg = tkv.CacheConfig(fmt=fmt, page_size=16, window=window)
    k, v = _kv(np.random.default_rng(4), B, S, Hkv, dh)
    jc = jkv.init_gqa_cache(jcfg, B, 64, Hkv, dh)
    tc = tkv.init_gqa_cache(tcfg, B, 64, Hkv, dh)
    assert tc.capacity == 32
    append = jax.jit(lambda c, a, b: jkv.gqa_append(c, jcfg, a, b))
    for t in range(S):
        jc = append(jc, jnp.asarray(k[:, t]), jnp.asarray(v[:, t]))
        tc = tkv.gqa_append(tc, tcfg, torch.from_numpy(k[:, t]), torch.from_numpy(v[:, t]))
        if t in (0, 31, 32, S - 1):
            assert_same_cache(tc, jc)
    bulk = tkv.gqa_prefill(tkv.init_gqa_cache(tcfg, B, 64, Hkv, dh), tcfg,
                           torch.from_numpy(k), torch.from_numpy(v))
    assert_same_cache(tc, bulk)
    assert sorted(tc.slot_pos[0].tolist()) == list(range(S - 32, S))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("window", [0, 16])
def test_append_active_gate_bytes(fmt, window):
    """Inactive rows keep their slot and ``seq_lens``; active rows append,
    over a prefilled cache, twice (the second step past the 16-slot ring
    wraps); the unwindowed append past capacity clamps to the last slot."""
    B, Hkv, dh = 3, 2, 16
    jcfg = jkv.CacheConfig(fmt=fmt, page_size=16, window=window)
    tcfg = tkv.CacheConfig(fmt=fmt, page_size=16, window=window)
    rng = np.random.default_rng([7, window])
    k, v = _kv(rng, B, 15, Hkv, dh)
    jc = jax.jit(lambda c, a, b: jkv.gqa_prefill(c, jcfg, a, b))(
        jkv.init_gqa_cache(jcfg, B, 16, Hkv, dh), jnp.asarray(k), jnp.asarray(v))
    tc = bridge.gqa_cache_from_jax(jax.tree.map(np.asarray, jc))
    append = jax.jit(lambda c, a, b, act: jkv.gqa_append(c, jcfg, a, b, active=act))
    for active in ([True, False, True], [False, True, True], [True, True, True]):
        a, b = _kv(rng, B, 1, Hkv, dh, scale=2.0)
        act = np.array(active)
        jc = append(jc, jnp.asarray(a[:, 0]), jnp.asarray(b[:, 0]), jnp.asarray(act))
        tc = tkv.gqa_append(tc, tcfg, torch.from_numpy(a[:, 0]), torch.from_numpy(b[:, 0]),
                            active=torch.from_numpy(act))
        assert_same_cache(tc, jc)
    assert tc.seq_lens.tolist() == [17, 17, 18]
