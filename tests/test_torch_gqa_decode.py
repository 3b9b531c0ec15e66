"""The port's FP8 GQA decode (``repro_torch/kernels/gqa_decode``) against the
JAX package's on the reference's grid: (Hkv, g, dh, window) in {(1, 8, 32, 0),
(2, 8, 64, 0), (4, 2, 32, 96), (8, 1, 16, 0)} at B 2, S 150, N 192, block 64.
This file holds fp8_e4m3 and the edge cases; ``test_torch_gqa_decode_int8.py``
and ``test_torch_gqa_decode_none.py`` run ``check_grid_case`` on the other
formats.

Each case holds, within rtol / atol 1e-5 unless stated: the port's plain
version against the JAX ``gqa_decode`` with its Pallas kernel (interpret mode)
and with ``use_kernel=False``; the port's parallel form against the JAX
parallel form; the port's pipeline against its parallel form (rtol 1e-4, atol
1e-5, the reference's gate); window semantics against the dequantize-first
oracle (relative error < 0.08). The cache is built by the JAX package, with
unit input scales, and carried over byte for byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.core import kvcache as jkv
from repro.kernels.gqa_decode import ops as jops
from repro.kernels.gqa_decode import ref as JR
from repro_torch import bridge
from repro_torch.core import attention as TA
from repro_torch.kernels import _lib
from repro_torch.kernels.gqa_decode import kernel as TK
from repro_torch.kernels.gqa_decode import ops as tops
from repro_torch.kernels.gqa_decode import ref as TR

B, S, N, BN = 2, 150, 192, 64
GRID = [(1, 8, 32, 0), (2, 8, 64, 0), (4, 2, 32, 96), (8, 1, 16, 0)]
TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(Hkv, g, dh, window, fmt, *, seed=0, s=S, n=N, page=BN):
    """A JAX-built cache (prefilled with s tokens of seeded normal K, V) and
    query, as JAX arrays and as the port's tensors."""
    rng = np.random.default_rng([seed, Hkv, g, dh, window])
    cfg = jkv.CacheConfig(fmt=fmt, page_size=page, window=window)
    k = rng.standard_normal((B, s, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, s, Hkv, dh)).astype(np.float32)
    cache = jax.jit(lambda c, a, b: jkv.gqa_prefill(c, cfg, a, b))(
        jkv.init_gqa_cache(cfg, B, n, Hkv, dh), jnp.asarray(k), jnp.asarray(v))
    q = rng.standard_normal((B, Hkv * g, dh)).astype(np.float32)
    positions = np.full((B,), s - 1, np.int32)
    tcache = bridge.gqa_cache_from_jax(jax.tree.map(np.asarray, cache))
    return cache, jnp.asarray(q), jnp.asarray(positions), tcache, torch.from_numpy(q), \
        torch.from_numpy(positions)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_grid_case(fmt, Hkv, g, dh, window):
    jc, jq, jpos, tc, tq, tpos = make_case(Hkv, g, dh, window, fmt)
    kw = dict(window=window, block_n=BN, fmt=fmt)
    t_plain = tops.gqa_decode(tq, tc, tpos, use_kernel=False, **kw)
    j_kernel = jops.gqa_decode(jq, jc, jpos, use_kernel=True, **kw)
    j_pipe = jops.gqa_decode(jq, jc, jpos, use_kernel=False, **kw)
    np.testing.assert_allclose(_np(t_plain), _np(j_kernel), **TOL)
    np.testing.assert_allclose(_np(t_plain), _np(j_pipe), **TOL)
    args_j = (jq, jc.k, jc.v, jc.k_scale, jc.v_scale, jc.slot_pos, jpos)
    args_t = (tq, tc.k, tc.v, tc.k_scale, tc.v_scale, tc.slot_pos, tpos)
    j_par = jax.jit(lambda *a: JR.gqa_decode_parallel_ref(*a, **kw))(*args_j)
    t_par = TR.gqa_decode_parallel_ref(*args_t, **kw)
    np.testing.assert_allclose(_np(t_par), _np(j_par), **TOL)
    t_pipe = TR.gqa_decode_pipeline_ref(*args_t, **kw)
    np.testing.assert_allclose(_np(t_pipe), _np(t_par), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(t_pipe), _np(t_plain))     # N % block_n == 0
    exact = TA.gqa_decode_dequant_ref(tq, tc, tpos, window=window)
    rel = np.abs(_np(t_plain) - _np(exact)).max() / np.abs(_np(exact)).max()
    assert rel < 0.08, rel
    assert np.isfinite(_np(t_plain)).all()


@pytest.mark.parametrize("Hkv,g,dh,window", GRID)
def test_fp8_grid_matches_jax(Hkv, g, dh, window):
    check_grid_case("fp8_e4m3", Hkv, g, dh, window)


def test_dequant_oracles_match_jax():
    """``gqa_decode_dequant_ref`` and ``mla_decode_dequant_ref``, the
    dequantize-first oracles of core/attention.py."""
    jc, jq, jpos, tc, tq, tpos = make_case(2, 4, 32, 64, "fp8_e4m3")
    want = jax.jit(lambda q, c, p: JA.gqa_decode_dequant_ref(q, c, p, window=64))(jq, jc, jpos)
    np.testing.assert_allclose(_np(TA.gqa_decode_dequant_ref(tq, tc, tpos, window=64)),
                               _np(want), **TOL)
    rng = np.random.default_rng(5)
    mcfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=16)
    c_kv = rng.standard_normal((2, 40, 32)).astype(np.float32)
    k_r = rng.standard_normal((2, 40, 16)).astype(np.float32)
    mc = jax.jit(lambda c, a, b: jkv.mla_prefill(c, mcfg, a, b))(
        jkv.init_mla_cache(mcfg, 2, 48, 32, 16), jnp.asarray(c_kv), jnp.asarray(k_r))
    q_lat = rng.standard_normal((2, 4, 32)).astype(np.float32)
    q_r = rng.standard_normal((2, 4, 16)).astype(np.float32)
    want = jax.jit(lambda a, b, c: JA.mla_decode_dequant_ref(a, b, c, 0.125))(
        jnp.asarray(q_lat), jnp.asarray(q_r), mc)
    got = TA.mla_decode_dequant_ref(torch.from_numpy(q_lat), torch.from_numpy(q_r),
                                    bridge.cache_from_jax(jax.tree.map(np.asarray, mc)), 0.125)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_all_invalid_row_is_nan_on_both_sides():
    """A row whose query position precedes every slot (here: a window that
    excludes every cached token) has no valid slot: 0 / 0 = NaN in the
    kernel's arithmetic and its plain version, finite rows untouched."""
    jc, jq, _, tc, tq, _ = make_case(2, 4, 32, 16, "fp8_e4m3")
    positions = np.array([S - 1, S + 100], np.int32)        # row 1: window past the cache
    kw = dict(window=16, block_n=BN, fmt="fp8_e4m3")
    j_k = _np(jops.gqa_decode(jq, jc, jnp.asarray(positions), **kw))
    t_p = _np(tops.gqa_decode(tq, tc, torch.from_numpy(positions), use_kernel=False, **kw))
    assert np.isnan(j_k[1]).all() and np.isnan(t_p[1]).all()
    np.testing.assert_allclose(t_p[0], j_k[0], **TOL)


def test_capacity_not_multiple_of_block_pads_like_jax():
    """N = 80 with block_n = 64: both sides pad to 128 with empty slots."""
    jc, jq, jpos, tc, tq, tpos = make_case(2, 4, 32, 0, "fp8_e4m3", s=70, n=80, page=16)
    assert tc.capacity == 80
    kw = dict(window=0, block_n=BN, fmt="fp8_e4m3")
    want = _np(jops.gqa_decode(jq, jc, jpos, use_kernel=True, **kw))
    np.testing.assert_allclose(_np(tops.gqa_decode(tq, tc, tpos, use_kernel=False, **kw)),
                               want, **TOL)
    padded = TR.pad_to_block(tc.k, tc.v, tc.k_scale, tc.v_scale, tc.slot_pos, BN)
    assert padded[0].shape[1] == 128 and (padded[4][:, 80:] == -1).all()
    assert (padded[2][:, 80:] == 1).all() and (padded[0][:, 80:].view(torch.uint8) == 0).all()


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_cpu_kernel_entry_is_the_plain_version(fmt):
    """On CPU tensors the kernel entry runs its plain version: bitwise equal,
    no launch counted."""
    _, _, _, tc, tq, tpos = make_case(4, 2, 32, 96, fmt)
    _lib.reset_launches()
    got = tops.gqa_decode(tq, tc, tpos, window=96, block_n=BN, fmt=fmt, use_kernel=True)
    want = TK.gqa_decode_plain(tq, tc.k, tc.v, tc.k_scale, tc.v_scale, tc.slot_pos, tpos,
                               window=96, block_n=BN, fmt=fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert sum(_lib.LAUNCHES.values()) == 0


def test_ring_cache_decode_matches_jax():
    """A wrapped ring (S 50 into a window-32 cache, page 16) through both
    decodes."""
    jc, jq, jpos, tc, tq, tpos = make_case(2, 2, 16, 32, "fp8_e4m3", s=50, n=64, page=16)
    assert tc.capacity == 32
    kw = dict(window=32, block_n=16, fmt="fp8_e4m3")
    np.testing.assert_allclose(_np(tops.gqa_decode(tq, tc, tpos, **kw)),
                               _np(jops.gqa_decode(jq, jc, jpos, **kw)), **TOL)


def test_plain_version_rejects_ragged_cache():
    _, _, _, tc, tq, tpos = make_case(2, 4, 32, 0, "fp8_e4m3", s=70, n=80, page=16)
    with pytest.raises(ValueError, match="multiple of block_n"):
        TR.gqa_decode_pipeline_ref(tq, tc.k, tc.v, tc.k_scale, tc.v_scale, tc.slot_pos,
                                   tpos, block_n=BN)
