"""The port's fused fetch-dequant (plain version of the CUDA kernel #11 / #10)
and the chunked-prefill attentions against the JAX package: fetches bit for
bit against jitted JAX (contiguous, full paged, bounded paged with a
scrambled table and chunk_start at 0, mid-page, a page edge and capacity),
``paged_mla_prefill_at`` pool bytes identical outside the scratch page 0,
and the attentions within atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.core import mla as JM
from repro.kernels.quantize import fetch_dequant as JFD
from repro_torch import bridge
from repro_torch.core import kvcache as tkv
from repro_torch.core import mla as TM
from repro_torch.kernels import _lib
from repro_torch.kernels.quantize import fetch_dequant as TFD

D_C, D_R, PAGE = 32, 16, 16


def _np(x):
    return jax.tree.map(np.asarray, x)


def _bits(x) -> np.ndarray:
    """Raw bytes of a bf16 array (JAX or torch) as int16."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture(scope="module")
def pools():
    """A scrambled-table JAX pool (fp8) filled by a bulk paged prefill, its
    port twin, and the contiguous cache of the same rows."""
    rng = np.random.RandomState(0)
    cfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=PAGE)
    table = np.array([[5, 2, 9, 11], [1, 7, 3, 10], [4, 8, 6, 12]], np.int32)
    B, P = table.shape
    S = P * PAGE
    pool = jkv.init_paged_mla_pool(cfg, 14, P, B, D_C, D_R)._replace(
        page_table=jnp.asarray(table))
    c = jnp.asarray(rng.standard_normal((B, S, D_C)).astype(np.float32) * 2)
    r = jnp.asarray(rng.standard_normal((B, S, D_R)).astype(np.float32) * 15)
    pool = jax.jit(jkv.paged_mla_prefill, static_argnums=1)(pool, cfg, c, r)
    cache = jkv.mla_prefill(jkv.init_mla_cache(cfg, B, S, D_C, D_R), cfg, c, r)
    return pool, bridge.pool_from_jax(_np(pool)), cache, bridge.cache_from_jax(_np(cache))


def test_contiguous_fetch_bit_exact(pools):
    _, _, jcache, tcache = pools
    want = jax.jit(JFD.fetch_dequant_ref)(jcache)
    _lib.reset_launches()
    got = TFD.fetch_dequant(tcache, page=PAGE)
    assert sum(_lib.LAUNCHES.values()) == 0          # CPU tensors: the plain version
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("chunk_start", [None, [0, 0, 0], [7, 24, 40], [16, 32, 48],
                                         [64, 64, 64], [0, 33, 64]])
def test_paged_fetch_bit_exact(pools, chunk_start):
    """Full mode and bounded mode (chunk_start at 0, mid-page, a page edge,
    the capacity): bit for bit, dead pages zero."""
    jpool, tpool, _, _ = pools
    if chunk_start is None:
        want = jax.jit(JFD.paged_fetch_dequant_ref)(jpool)
        got = TFD.paged_fetch_dequant(tpool)
    else:
        cs = np.asarray(chunk_start, np.int32)
        want = jax.jit(lambda p, c: JFD.paged_fetch_dequant_ref(p, chunk_start=c))(
            jpool, jnp.asarray(cs))
        got = TFD.paged_fetch_dequant(tpool, chunk_start=torch.from_numpy(cs))
        for b, c0 in enumerate(cs):
            assert not got[b, -(-int(c0) // PAGE) * PAGE:].any()
    assert got.shape == (3, 4 * PAGE, D_C + D_R) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_paged_fetch_equals_contiguous_fetch(pools):
    _, tpool, _, tcache = pools
    np.testing.assert_array_equal(_bits(TFD.paged_fetch_dequant(tpool)),
                                  _bits(TFD.fetch_dequant(tcache, page=PAGE)))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_paged_prefill_at_pool_bytes_match_jax(fmt):
    """Chunked writes (the last chunk padded, one chunk running past the
    table span) land on the same (page, slot) cells as jitted JAX; only the
    scratch page 0 may differ (duplicate padded rows land there)."""
    rng = np.random.RandomState(1)
    jcfg = jkv.CacheConfig(fmt=fmt, page_size=PAGE)
    tcfg = tkv.CacheConfig(fmt=fmt, page_size=PAGE)
    jpool = jkv.init_paged_mla_pool(jcfg, 12, 3, 2, D_C, D_R)._replace(
        page_table=jnp.asarray([[4, 6, 2], [7, 1, 9]], jnp.int32))
    tpool = bridge.pool_from_jax(_np(jpool))
    write = jax.jit(jkv.paged_mla_prefill_at, static_argnums=1)
    for start, width in ((0, 16), (16, 16), (32, 10), (40, 16)):
        c = rng.standard_normal((2, 16, D_C)).astype(np.float32) * 2
        r = rng.standard_normal((2, 16, D_R)).astype(np.float32) * 15
        valid = np.broadcast_to(np.arange(16) < width, (2, 16))
        starts = np.asarray([start, start], np.int32)
        jpool = write(jpool, jcfg, jnp.asarray(c), jnp.asarray(r), jnp.asarray(starts),
                      jnp.asarray(valid))
        tpool = tkv.paged_mla_prefill_at(tpool, tcfg, torch.from_numpy(c),
                                         torch.from_numpy(r), torch.from_numpy(starts),
                                         torch.from_numpy(np.ascontiguousarray(valid)))
        np.testing.assert_array_equal(tpool.seq_lens.numpy(), np.asarray(jpool.seq_lens))
    got = bridge.pool_from_jax(_np(jpool))
    for name in ("content", "rope", "scale"):
        a, b = getattr(tpool, name), getattr(got, name)
        view = torch.uint8 if a.dtype == torch.float8_e4m3fn else a.dtype
        assert torch.equal(a[1:].view(view), b[1:].view(view)), name


def _chunk_setup(seed, B=2, S=64, C=32, page=PAGE):
    """MLA projections of a random hidden sequence, JAX and port weights."""
    cfg = JM.MLAConfig(d_model=64, n_heads=4, d_head=16, d_rope=D_R, d_c=D_C)
    jparams = JM.init_mla_params(jax.random.PRNGKey(seed), cfg)
    h = jnp.asarray(np.random.RandomState(seed).standard_normal((B, S, 64)).astype(np.float32))
    pos = jnp.arange(S)
    q_c, q_r = JM.project_q(jparams, cfg, h, pos)
    c_kv, k_r = JM.project_kv(jparams, cfg, h, pos)
    return cfg, JM.absorb_q(jparams, q_c), q_r, c_kv, k_r


@pytest.mark.parametrize("last_width", [32, 13])
def test_paged_chunked_attention_matches_jax(last_width):
    """Chunk by chunk over a shared pool (prefix read back through the
    bounded fetch), the final chunk padded: the port against JAX within
    atol 1e-5 on the valid rows, on the same inputs."""
    cfg, q_lat, q_r, c_kv, k_r = _chunk_setup(5)
    B, S, C = 2, 64, 32
    jcfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=PAGE)
    tcfg = tkv.CacheConfig(fmt="fp8_e4m3", page_size=PAGE)
    table = 1 + np.arange(B * S // PAGE, dtype=np.int32).reshape(B, -1)
    jpool = jkv.init_paged_mla_pool(jcfg, B * S // PAGE + 1, S // PAGE, B, D_C, D_R)._replace(
        page_table=jnp.asarray(table))
    tpool = bridge.pool_from_jax(_np(jpool))
    for start in (0, C):
        width = C if start == 0 else last_width
        sl = slice(start, start + C)
        valid = np.broadcast_to(np.arange(C) < width, (B, C)).copy()
        starts = np.full((B,), start, np.int32)
        args = (q_lat[:, sl], q_r[:, sl], c_kv[:, sl], k_r[:, sl])
        jpool = jkv.paged_mla_prefill_at(jpool, jcfg, args[2], args[3], jnp.asarray(starts),
                                         jnp.asarray(valid))
        want = JFD.paged_chunked_prefill_attention(
            args[0], args[1], jpool, args[2], args[3], jnp.asarray(starts),
            jnp.asarray(valid), softmax_scale=cfg.softmax_scale)
        targs = [torch.from_numpy(np.array(a)) for a in args]
        tpool = tkv.paged_mla_prefill_at(tpool, tcfg, targs[2], targs[3],
                                         torch.from_numpy(starts), torch.from_numpy(valid))
        for use_kernel in (False, True):
            got = TFD.paged_chunked_prefill_attention(
                targs[0], targs[1], tpool, targs[2], targs[3], torch.from_numpy(starts),
                torch.from_numpy(valid), softmax_scale=cfg.softmax_scale,
                use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy()[:, :width], np.asarray(want)[:, :width],
                                       rtol=1e-5, atol=1e-5)


def test_first_chunk_is_full_precision():
    """A first chunk never reads the quantized pool: the port's result equals
    the full-precision causal attention to float tolerance
    (tests/test_fetch_dequant.py:199-227)."""
    cfg, q_lat, q_r, c_kv, k_r = _chunk_setup(3, C=32, S=32)
    B, C = 2, 32
    logits = (jnp.einsum("bshc,bnc->bshn", q_lat, c_kv)
              + jnp.einsum("bshr,bnr->bshn", q_r, k_r)) * cfg.softmax_scale
    mask = jnp.tril(jnp.ones((C, C), bool))
    logits = jnp.where(mask[None, :, None, :], logits, -jnp.inf)
    o_ref = jnp.einsum("bshn,bnc->bshc", jax.nn.softmax(logits, -1), c_kv)
    tcfg = tkv.CacheConfig(fmt="fp8_e4m3", page_size=32)
    pool = tkv.init_paged_mla_pool(tcfg, 4, 1, B, D_C, D_R)._replace(
        page_table=torch.tensor([[1], [2]], dtype=torch.int32))
    t = [torch.from_numpy(np.asarray(a)) for a in (q_lat, q_r, c_kv, k_r)]
    starts, valid = torch.zeros(B, dtype=torch.int32), torch.ones(B, C, dtype=torch.bool)
    pool = tkv.paged_mla_prefill_at(pool, tcfg, t[2], t[3], starts, valid)
    o = TFD.paged_chunked_prefill_attention(t[0], t[1], pool, t[2], t[3], starts, valid,
                                            softmax_scale=cfg.softmax_scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    # the verify form is the same attention with every draft key valid
    ov = TFD.paged_verify_attention(t[0], t[1], pool, t[2], t[3], starts,
                                    softmax_scale=cfg.softmax_scale)
    torch.testing.assert_close(ov, o, rtol=0, atol=0)


@pytest.mark.parametrize("chunk_start", [0, 16, 40])
def test_contiguous_chunked_attention_matches_jax(chunk_start):
    cfg, q_lat, q_r, c_kv, k_r = _chunk_setup(7)
    B, C = 2, 16
    jcfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=PAGE)
    jcache = jkv.mla_prefill(jkv.init_mla_cache(jcfg, B, 64, D_C, D_R), jcfg,
                             c_kv[:, :chunk_start + C], k_r[:, :chunk_start + C])
    sl = slice(chunk_start, chunk_start + C)
    want = JFD.chunked_prefill_attention(q_lat[:, sl], q_r[:, sl], jcache, chunk_start,
                                         softmax_scale=cfg.softmax_scale, page=PAGE,
                                         use_kernel=False)
    tcache = bridge.cache_from_jax(_np(jcache))
    for use_kernel in (False, True):
        got = TFD.chunked_prefill_attention(
            torch.from_numpy(np.asarray(q_lat[:, sl])), torch.from_numpy(np.asarray(q_r[:, sl])),
            tcache, chunk_start, softmax_scale=cfg.softmax_scale, page=PAGE,
            use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mla_params_bridge_used_by_chunk_setup():
    """The chunk tests hand the port the JAX projections; the port's own
    projections of the same bridged weights agree (so the model-level chunk
    tests compare like with like)."""
    cfg = JM.MLAConfig(d_model=64, n_heads=4, d_head=16, d_rope=D_R, d_c=D_C)
    jp = JM.init_mla_params(jax.random.PRNGKey(5), cfg)
    tp = bridge.mla_params_from_jax(_np(jp))
    tcfg = TM.MLAConfig(d_model=64, n_heads=4, d_head=16, d_rope=D_R, d_c=D_C)
    h = np.random.RandomState(5).standard_normal((2, 8, 64)).astype(np.float32)
    pos = np.arange(8)
    jc, jr = JM.project_kv(jp, cfg, jnp.asarray(h), jnp.asarray(pos))
    tc, tr = TM.project_kv(tp, tcfg, torch.from_numpy(h), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
