"""The port's contiguous MLA cache path against the JAX package: cache bytes
after prefill and appends (capacity clamp, ``active`` gate, P-Cast sink
guard) identical to jitted JAX; contiguous decode (single pass #1, split-KV
#2) against the JAX Pallas kernels (interpret mode) and refs on the SAME
cache bytes within 1e-5 (tests/test_splitkv.py's gate), sink-guarded
caches included; Fused-K-Append (#9) bytes; split resolution; the backend
registry; and contiguous == paged inside the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.kernels.mla_decode import backends as JB
from repro.kernels.mla_decode import ops as jops
from repro.kernels.mla_decode import ref as JR
from repro.kernels.mla_decode.kernel import mla_decode_pallas, mla_decode_splitkv_pallas
from repro.kernels.quantize import ops as jqops
from repro_torch import bridge
from repro_torch.core import kvcache as tkv
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import kernel as TK
from repro_torch.kernels.mla_decode import ops as tops
from repro_torch.kernels.quantize import ops as tqops

SCALE = 0.1
H, D_C, D_R = 4, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _cache_bytes(cache):
    out = []
    for name in ("content", "rope", "scale", "seq_lens", "sink"):
        x = getattr(cache, name)
        if x is None:
            out.append(None)
            continue
        if isinstance(x, torch.Tensor):
            x = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else (
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
            out.append(x.numpy())
        else:
            a = np.asarray(x)
            out.append(a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else (
                a.view(np.int16) if a.dtype.name == "bfloat16" else a))
    return out


def _assert_caches_equal(t, j):
    for a, b in zip(_cache_bytes(t), _cache_bytes(j)):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("sink_tokens", [0, 5, 40])
def test_prefill_and_append_identical_bytes(fmt, sink_tokens):
    """A prefill that ends mid-page, appends across a page boundary, an
    ``active`` gate, and appends past capacity (clamped to the last row);
    the sink shadow follows every write (S_k = min(sink_tokens, N))."""
    B, page, max_len = 3, 16, 40
    jcfg = jkv.CacheConfig(fmt=fmt, page_size=page, sink_tokens=sink_tokens)
    tcfg = tkv.CacheConfig(fmt=fmt, page_size=page, sink_tokens=sink_tokens)
    jc = jkv.init_mla_cache(jcfg, B, max_len, D_C, D_R)
    tc = tkv.init_mla_cache(tcfg, B, max_len, D_C, D_R)
    _assert_caches_equal(tc, jc)
    assert tc.capacity == jc.capacity == 48 and tc.sink_tokens == jc.sink_tokens
    S = 2
    c, r = _np(1, (B, S, D_C), 2.0), _np(2, (B, S, D_R), 25.0)
    jc = jax.jit(jkv.mla_prefill, static_argnums=1)(jc, jcfg, c, r)
    tc = tkv.mla_prefill(tc, tcfg, torch.from_numpy(c), torch.from_numpy(r))
    _assert_caches_equal(tc, jc)
    append = jax.jit(jkv.mla_append, static_argnums=1)
    rs = np.random.RandomState(3)
    for step in range(52):                     # 2 + 52 > capacity 48: clamp
        cn, rn = _np(100 + step, (B, D_C), 2.0), _np(200 + step, (B, D_R), 25.0)
        active = rs.rand(B) > 0.3 if step % 3 == 1 else None
        jc = append(jc, jcfg, cn, rn, None if active is None else jnp.asarray(active))
        tc = tkv.mla_append(tc, tcfg, torch.from_numpy(cn), torch.from_numpy(rn),
                            None if active is None else torch.from_numpy(active))
        _assert_caches_equal(tc, jc)
    assert int(tc.seq_lens.max()) > tc.capacity
    np.testing.assert_array_equal(tkv.sink_patched_content(tc).float().numpy(),
                                  np.asarray(jkv.sink_patched_content(jc), np.float32))


def test_bridge_carries_the_cache_and_its_sink():
    cfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=16, sink_tokens=3)
    jc = jax.jit(jkv.mla_prefill, static_argnums=1)(
        jkv.init_mla_cache(cfg, 2, 20, D_C, D_R), cfg, _np(4, (2, 9, D_C)),
        _np(5, (2, 9, D_R)))
    tc = bridge.cache_from_jax(jax.tree.map(np.asarray, jc))
    assert isinstance(tc, tkv.MLACache) and tc.sink.dtype == torch.float32
    _assert_caches_equal(tc, jc)
    plain = jkv.init_mla_cache(jkv.CacheConfig(page_size=16), 2, 20, D_C, D_R)
    assert bridge.cache_from_jax(jax.tree.map(np.asarray, plain)).sink is None


def _setup(fmt, lens, N, sink_tokens=0, seed=0):
    """A JAX-quantized contiguous cache (a prefill, which fills the sink
    shadow too, then ragged ``lens``) and a JAX-prepared query; returns (JAX
    cache, port cache, JAX query, port query)."""
    B = len(lens)
    cfg = jkv.CacheConfig(fmt=fmt, page_size=16, sink_tokens=sink_tokens)
    rs = np.random.RandomState(seed)
    jc = jax.jit(jkv.mla_prefill, static_argnums=1)(
        jkv.init_mla_cache(cfg, B, N, D_C, D_R), cfg,
        rs.standard_normal((B, N - 2, D_C)).astype(np.float32),
        (rs.standard_normal((B, N - 2, D_R)) * 2).astype(np.float32))
    jc = jc._replace(seq_lens=jnp.asarray(lens, jnp.int32))
    q = jax.jit(JR.prepare_q, static_argnums=2)(
        rs.standard_normal((B, H, D_C)).astype(np.float32),
        rs.standard_normal((B, H, D_R)).astype(np.float32), fmt)
    tq = tuple(bridge.to_torch(np.asarray(x)) for x in q)
    return jc, bridge.cache_from_jax(jax.tree.map(np.asarray, jc)), q, tq


LENS = [0, 16, 37, 64, 128]


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("block_n,num_splits", [(16, 1), (16, 2), (16, 4), (64, 1),
                                                (64, 2), (64, 4)])
def test_contiguous_splitkv_matches_pallas_and_ref(fmt, block_n, num_splits):
    jc, tc, q, tq = _setup(fmt, LENS, 256 if block_n == 64 else 128, seed=1)
    j_ops = tuple(q) + (jc.content, jc.rope.astype(jnp.float32), jc.scale, jc.seq_lens)
    t_ops = tq + (tc.content, tc.rope, tc.scale, tc.seq_lens)
    kw = dict(softmax_scale=SCALE, num_splits=num_splits, block_n=block_n, fmt=fmt,
              return_partials=True)
    o_k, lse_k, (op_k, lp_k, sp_k) = mla_decode_splitkv_pallas(*j_ops, **kw)
    o_r, lse_r, _ = JR.snapmla_decode_splitkv_ref(*j_ops, **kw)
    o_t, lse_t, (op_t, lp_t, sp_t) = TK.mla_decode_splitkv_cuda(*t_ops, **kw)
    for o, lse in ((o_k, lse_k), (o_r, lse_r)):
        _close(o_t, o)
        _close(lse_t, lse)
    _close(op_t, op_k)
    _close(lp_t, lp_k)
    _close(sp_t, sp_k, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("block_n", [16, 64])
def test_contiguous_single_pass_matches_pallas(fmt, block_n):
    """#1's plain version == the JAX single-pass kernel, the empty row
    included ((NaN, -inf) in both)."""
    jc, tc, q, tq = _setup(fmt, LENS, 128, seed=2)
    kw = dict(softmax_scale=SCALE, block_n=block_n, fmt=fmt)
    o_k, lse_k = mla_decode_pallas(*q, jc.content, jc.rope.astype(jnp.float32), jc.scale,
                                   jc.seq_lens, **kw)
    o_t, lse_t = TK.mla_decode_cuda(*tq, tc.content, tc.rope, tc.scale, tc.seq_lens, **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_k), equal_nan=True, **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_k), equal_nan=True, **TOL)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("num_splits", [1, 2])
def test_contiguous_amla_matches_pallas(rescale, num_splits):
    jc, tc, q, tq = _setup("fp8_e4m3", [20, 128, 65, 99], 128, seed=3)
    kw = dict(softmax_scale=SCALE, block_n=32, rescale=rescale)
    j_ops = tuple(q) + (jc.content, jc.rope.astype(jnp.float32), jc.scale, jc.seq_lens)
    if num_splits == 1:
        o_k, lse_k = mla_decode_pallas(*j_ops, **kw)
        o_t, lse_t = TK.mla_decode_cuda(*tq, tc.content, tc.rope, tc.scale, tc.seq_lens, **kw)
    else:
        o_k, lse_k = mla_decode_splitkv_pallas(*j_ops, num_splits=num_splits, **kw)
        o_t, lse_t = TK.mla_decode_splitkv_cuda(*tq, tc.content, tc.rope, tc.scale,
                                                tc.seq_lens, num_splits=num_splits, **kw)
    o_tol = dict(rtol=0, atol=1e-4) if rescale == "amla" else TOL
    _close(o_t, o_k, **o_tol)
    _close(lse_t, lse_k, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sink_tokens", [4, 40])
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_sink_guarded_decode_matches_jax(sink_tokens, num_splits, use_kernel):
    """``snapmla_decode`` on a sink-guarded cache against the JAX dispatch
    (sink_patched_content + Pallas kernel / ref). On rows below S_k the
    content is float32, so the port's float64 QK sum is no longer exact in
    every order; at these scales it stays within the decode gate."""
    jc, tc, q, tq = _setup("fp8_e4m3", [20, 128, 65, 99], 128, sink_tokens, seed=4)
    assert tc.sink_tokens == sink_tokens
    kw = dict(softmax_scale=SCALE, block_n=16, num_splits=num_splits)
    o_j, lse_j = jops.snapmla_decode(*q, jc, use_kernel=use_kernel, **kw)
    o_t, lse_t = tops.snapmla_decode(*tq, tc, use_kernel=use_kernel, **kw)
    _close(o_t, o_j)
    _close(lse_t, lse_j)
    o_u, _ = tops.snapmla_decode(*tq, tc._replace(sink=None), **kw)
    assert float((o_u - o_t).abs().max()) > 1e-4      # the guard changes the result


@pytest.mark.parametrize("num_splits", [1, 2])
def test_ops_dispatch_and_contiguous_backends(num_splits):
    jc, tc, q, tq = _setup("fp8_e4m3", [20, 128, 65], 128, seed=5)
    o_kern, _ = tops.snapmla_decode(*tq, tc, softmax_scale=SCALE, block_n=16,
                                    num_splits=num_splits)
    args = tq + (tc.content, tc.rope, tc.scale, tc.seq_lens)
    direct = (TK.mla_decode_cuda(*args, softmax_scale=SCALE, block_n=16)[0]
              if num_splits == 1 else
              TK.mla_decode_splitkv_cuda(*args, softmax_scale=SCALE, block_n=16,
                                         num_splits=num_splits)[0])
    np.testing.assert_array_equal(o_kern.numpy(), direct.numpy())
    cfg = TB.BackendConfig(softmax_scale=SCALE, block_n=16, num_splits=num_splits)
    dq = TB.DecodeQuery(*tq)
    o_ref = TB.resolve_backend("ref").decode(dq, tc, cfg)
    o_cuda = TB.resolve_backend("kernel").decode(dq, tc, cfg)
    np.testing.assert_array_equal(o_cuda.numpy(), o_kern.numpy())
    o_j, _ = jops.snapmla_decode(*q, jc, softmax_scale=SCALE, block_n=16,
                                 num_splits=num_splits, use_kernel=False)
    _close(o_cuda, o_j)
    # the reference backend is the parallel form, as the reference's jnp_ref
    jcfg = JB.BackendConfig(softmax_scale=SCALE, block_n=16, num_splits=num_splits)
    o_jr = jax.jit(lambda dq_, c: JB.get_backend("jnp_ref").decode(dq_, c, jcfg))(
        JB.DecodeQuery(*q), jc)
    _close(o_ref, o_jr)
    with pytest.raises(ValueError, match="multiple of block_n"):
        tops.snapmla_decode(*tq, tc, softmax_scale=SCALE, block_n=48)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_contiguous_equals_paged_at_page_blocks(rescale, num_splits):
    """A contiguous cache and a shuffled page pool holding the same blocks
    decode to identical bytes when block_n == page."""
    _, tc, _, tq = _setup("fp8_e4m3", [20, 128, 65, 99], 128, seed=6)
    B, page, P = 4, 16, 8
    perm = torch.from_numpy(np.random.RandomState(7).permutation(B * P).astype(np.int32))
    table = perm.reshape(B, P)
    pool = [torch.empty((B * P, page) + x.shape[2:], dtype=x.dtype)
            for x in (tc.content, tc.rope, tc.scale)]
    for x, dst in zip((tc.content, tc.rope, tc.scale), pool):
        dst[table.reshape(-1).long()] = x.reshape((B * P, page) + x.shape[2:])
    kw = dict(softmax_scale=SCALE, rescale=rescale)
    contig = tq + (tc.content, tc.rope, tc.scale, tc.seq_lens)
    paged = tq + tuple(pool) + (table, tc.seq_lens)
    if num_splits == 1:
        a = TK.mla_decode_cuda(*contig, block_n=page, **kw)
        b = TK.mla_decode_paged_cuda(*paged, **kw)
    else:
        a = TK.mla_decode_splitkv_cuda(*contig, block_n=page, num_splits=num_splits, **kw)
        b = TK.mla_decode_paged_splitkv_cuda(*paged, num_splits=num_splits, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_split_resolution_matches_reference():
    for cap in (16, 48, 64, 96, 128, 640, 4096, 32768):
        for bn in (0, 16, 32):
            for req in (None, 0, 1, 3, 16):
                t = tops.resolve_split_config(req, bn, cap)
                j = jops.resolve_split_config(req, bn, cap)
                assert (t.num_splits, t.block_n) == (j.num_splits, j.block_n), (cap, bn, req)
        t = tops.resolve_split_config(None, None, cap, layout="paged", page_size=16)
        j = jops.resolve_split_config(None, None, cap, layout="paged", page_size=16)
        assert (t.num_splits, t.block_n) == (j.num_splits, j.block_n)
    with pytest.raises(ValueError, match="repage"):
        tops.resolve_split_config(None, 32, 128, layout="paged", page_size=16)
    assert tops.DEFAULT_BLOCK_N == jops.DEFAULT_BLOCK_N


def test_backend_registry_layouts():
    assert TB.canonical_name("ref", False) == "torch_ref"
    assert TB.canonical_name("kernel", False) == "cuda_splitkv"
    assert TB.resolve_backend("auto").name == "torch_ref"
    assert TB.resolve_backend("auto", use_kernels=True).name == "cuda_splitkv"
    with pytest.raises(ValueError, match="consumes a paged pool"):
        TB.resolve_backend("cuda_paged_splitkv", paged=False)
    with pytest.raises(ValueError, match="consumes a contiguous MLACache"):
        TB.resolve_backend("torch_ref", paged=True)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
def test_fused_k_append_matches_jax(fmt):
    """#9's plain version writes the bytes JAX's Pallas kernel (interpret
    mode) and ref write, sink shadow and seq_lens included, and touches only
    row seq_lens[b]."""
    B, N, page = 3, 128, 32
    cfg = jkv.CacheConfig(fmt=fmt, page_size=page, sink_tokens=72)
    jc = jax.jit(jkv.mla_prefill, static_argnums=1)(
        jkv.init_mla_cache(cfg, B, N, D_C, D_R), cfg, _np(8, (B, 70, D_C)),
        _np(9, (B, 70, D_R)))
    jc = jc._replace(seq_lens=jnp.asarray([70, 3, 127], jnp.int32))
    c_new, r_new = _np(10, (B, D_C), 3.0), _np(11, (B, D_R), 10.0)
    c_new[1] = 0.0                                              # the EPS floor
    for use_kernel in (True, False):
        tc = bridge.cache_from_jax(jax.tree.map(np.asarray, jc))
        before = tkv.MLACache(*(x.clone() for x in tc))
        out_j = jqops.fused_k_append(jc, c_new, r_new, fmt=fmt, page=page,
                                     use_kernel=use_kernel)
        out_t = tqops.fused_k_append(tc, torch.from_numpy(c_new), torch.from_numpy(r_new),
                                     fmt=fmt)
        _assert_caches_equal(out_t, out_j)
        changed = (out_t.scale != before.scale) | (out_t.rope != before.rope).any(-1)
        rows = torch.nonzero(changed).tolist()
        assert all(t == int(before.seq_lens[b]) for b, t in rows)


def test_sequential_fused_appends_equal_prefill():
    B, N, S = 2, 64, 40
    cfg = tkv.CacheConfig(fmt="fp8_e4m3", page_size=16, sink_tokens=6)
    c, r = torch.from_numpy(_np(12, (B, S, D_C), 2.0)), torch.from_numpy(_np(13, (B, S, D_R), 20.0))
    bulk = tkv.mla_prefill(tkv.init_mla_cache(cfg, B, N, D_C, D_R), cfg, c, r)
    inc = tkv.init_mla_cache(cfg, B, N, D_C, D_R)
    for t in range(S):
        inc = tqops.fused_k_append(inc, c[:, t], r[:, t])
    for a, b in zip(_cache_bytes(inc), _cache_bytes(bulk)):
        np.testing.assert_array_equal(a, b)
