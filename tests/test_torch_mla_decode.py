"""Port decode oracles and kernel wrappers (CPU tensors -> plain versions)
against the JAX Pallas kernels (interpret mode) and JAX refs, on the SAME
quantized pool bytes carried over by ``repro_torch.bridge``.

Tolerances are those of tests/test_paged_splitkv.py:73-81 (1e-5; sigma_p
rtol 1e-6). The port accumulates QK dots in float64 and rounds once (see
repro_torch/kernels/mla_decode/ref.py), while XLA accumulates in float32:
the logits differ by a few float32 ulp of the dot's largest terms. The
inputs here are at the scale of an rms-normed latent and unit-scale queries,
where that difference stays below the fp8 rounding of P; at the reference
tests' stress scale (rope x25, q_r x5, logits ~1e2) it moves a few P codes
by one fp8 step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kvcache import CacheConfig, init_mla_cache, mla_prefill
from repro.kernels.mla_decode import ops as jops
from repro.kernels.mla_decode import ref as JR
from repro.kernels.mla_decode.kernel import (lse_combine_pallas, mla_decode_paged_pallas,
                                             mla_decode_paged_splitkv_pallas)
from repro_torch import bridge
from repro_torch.core.kvcache import PagedMLAPool
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import kernel as TK
from repro_torch.kernels.mla_decode import ops as tops
from repro_torch.kernels.mla_decode import ref as TR

SCALE = 0.1
PAGE, P, H, D_C, D_R = 16, 8, 4, 32, 16
# ragged batch: empty, exactly one page, mid-page, page-aligned, full
LENS = [0, 16, 37, 64, 128]
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(fmt, lens=LENS, seed=0):
    """A JAX-quantized cache scattered into a shuffled page pool, the query
    prepared by JAX; returns (jax operands, port operands)."""
    B, N = len(lens), P * PAGE
    rs = np.random.RandomState(seed)
    cfg = CacheConfig(fmt=fmt, page_size=PAGE)
    c = rs.standard_normal((B, N, D_C)).astype(np.float32)
    r = (rs.standard_normal((B, N, D_R)) * 2).astype(np.float32)
    cache = jax.jit(mla_prefill, static_argnums=1)(
        init_mla_cache(cfg, B, N, D_C, D_R), cfg, c, r)
    q_c = rs.standard_normal((B, H, D_C)).astype(np.float32)
    q_r = rs.standard_normal((B, H, D_R)).astype(np.float32)
    q = jax.jit(JR.prepare_q, static_argnums=2)(q_c, q_r, fmt)
    n_pool = B * P + 3
    perm = rs.permutation(n_pool)[: B * P].reshape(B, P)
    pc = np.zeros((n_pool, PAGE, D_C), np.asarray(cache.content).dtype)
    pr = np.zeros((n_pool, PAGE, D_R), np.asarray(cache.rope).dtype)
    ps = np.ones((n_pool, PAGE), np.float32)
    for b in range(B):
        for j in range(P):
            sl = slice(j * PAGE, (j + 1) * PAGE)
            pc[perm[b, j]] = np.asarray(cache.content[b, sl])
            pr[perm[b, j]] = np.asarray(cache.rope[b, sl])
            ps[perm[b, j]] = np.asarray(cache.scale[b, sl])
    np_pool = dict(content=pc, rope=pr, scale=ps, page_table=perm.astype(np.int32),
                   seq_lens=np.asarray(lens, np.int32))
    j_ops = tuple(jnp.asarray(x) for x in q) + (
        jnp.asarray(pc), jnp.asarray(pr), jnp.asarray(ps),
        jnp.asarray(np_pool["page_table"]), jnp.asarray(np_pool["seq_lens"]))
    pool = bridge.pool_from_jax(np_pool)
    t_q = tuple(bridge.to_torch(np.asarray(x)) for x in q)
    return j_ops, t_q + tuple(pool), pool


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_paged_splitkv_matches_pallas_and_ref(fmt, num_splits):
    j_ops, t_ops, _ = _setup(fmt)
    j_ops = j_ops[:4] + (j_ops[4].astype(jnp.float32),) + j_ops[5:]
    kw = dict(softmax_scale=SCALE, num_splits=num_splits, fmt=fmt,
              return_partials=True)
    o_k, lse_k, (op_k, lp_k, sp_k) = mla_decode_paged_splitkv_pallas(*j_ops, **kw)
    o_r, lse_r, _ = JR.snapmla_decode_paged_splitkv_ref(*j_ops, **kw)
    o_t, lse_t, (op_t, lp_t, sp_t) = TK.mla_decode_paged_splitkv_cuda(*t_ops, **kw)
    o_p, lse_p, _ = TR.snapmla_decode_paged_splitkv_ref(*t_ops, **kw)
    assert not torch.isnan(o_t).any()
    for o, lse in ((o_k, lse_k), (o_r, lse_r)):
        _close(o_t, o)
        _close(lse_t, lse)
    np.testing.assert_array_equal(o_t.numpy(), o_p.numpy())   # wrapper == its ref
    _close(sp_t, sp_k, rtol=1e-6, atol=0)
    _close(op_t, op_k)
    _close(lp_t, lp_k)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_paged_single_pass_matches_pallas(fmt):
    """Plain version of kernel B == the JAX single-pass paged kernel, the
    empty row included: JAX gives (NaN, -inf) there and so does the port."""
    j_ops, t_ops, _ = _setup(fmt, seed=1)
    o_k, lse_k = mla_decode_paged_pallas(*j_ops, softmax_scale=SCALE, fmt=fmt)
    o_t, lse_t = TK.mla_decode_paged_cuda(*t_ops, softmax_scale=SCALE, fmt=fmt)
    assert np.isnan(np.asarray(o_k)[0]).all() and np.isneginf(np.asarray(lse_k)[0]).all()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_k), equal_nan=True, **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_k), equal_nan=True, **TOL)


def test_single_pass_equals_one_split_when_all_pages_live():
    lens = [P * PAGE - 3, P * PAGE, (P - 1) * PAGE + 1]
    _, t_ops, _ = _setup("fp8_e4m3", lens=lens, seed=2)
    o_b, lse_b = TK.mla_decode_paged_cuda(*t_ops, softmax_scale=SCALE)
    o_a, lse_a = TK.mla_decode_paged_splitkv_cuda(*t_ops, softmax_scale=SCALE,
                                                   num_splits=1)
    np.testing.assert_array_equal(o_b.numpy(), o_a.numpy())
    np.testing.assert_array_equal(lse_b.numpy(), lse_a.numpy())


def test_lse_combine_matches_pallas_and_ref():
    rs = np.random.RandomState(3)
    o_p = rs.standard_normal((3, 4, H, D_C)).astype(np.float32)
    lse_p = (rs.standard_normal((3, 4, H)) * 3).astype(np.float32)
    lse_p[0, 1:] = TR.NEG_INF            # empty splits
    lse_p[1] = TR.NEG_INF                # an all-empty row
    o_p[0, 1:] = 0.0
    o_p[1] = 0.0
    o_k, lse_k = lse_combine_pallas(jnp.asarray(o_p), jnp.asarray(lse_p))
    o_r, lse_r = JR.lse_combine_ref(o_p, lse_p)
    o_t, lse_t = TK.lse_combine_cuda(torch.from_numpy(o_p), torch.from_numpy(lse_p))
    for o, lse in ((o_k, lse_k), (o_r, lse_r)):
        _close(o_t, o)
        _close(lse_t, lse)


def test_split_heuristic_matches_reference():
    for ctx in (16, 128, 4096, 8192, 8200, 16384, 32768, 65536, 131072):
        for bn in (16, 128):
            assert tops.default_num_splits(ctx, bn) == jops.default_num_splits(ctx, bn)
    assert tops.SPLIT_TARGET_TOKENS == jops.SPLIT_TARGET_TOKENS
    assert tops.MAX_SPLITS == jops.MAX_SPLITS
    assert tops.resolve_num_splits(None, 640, 128) == 1
    assert tops.resolve_num_splits(4, 640, 128) == 4
    assert tops.resolve_num_splits(16, 640, 128) == 5    # clamped to the pages
    assert tops.resolve_num_splits(0, 32768, 128) == 8


@pytest.mark.parametrize("num_splits", [1, 2])
def test_ops_dispatch_and_backends(num_splits):
    """``snapmla_decode_paged`` routes splits == 1 to the single-pass kernel
    and > 1 to split-KV + combine; the two registry backends agree."""
    lens = [20, 128, 65]
    j_ops, t_ops, pool = _setup("fp8_e4m3", lens=lens, seed=4)
    q = t_ops[:3]
    o_kern, _ = tops.snapmla_decode_paged(*q, pool, softmax_scale=SCALE,
                                          num_splits=num_splits)
    direct = (TK.mla_decode_paged_cuda(*t_ops, softmax_scale=SCALE)[0]
              if num_splits == 1 else
              TK.mla_decode_paged_splitkv_cuda(*t_ops, softmax_scale=SCALE,
                                               num_splits=num_splits)[0])
    np.testing.assert_array_equal(o_kern.numpy(), direct.numpy())
    cfg = TB.BackendConfig(softmax_scale=SCALE, num_splits=num_splits)
    dq = TB.DecodeQuery(*q)
    o_ref = TB.resolve_backend("ref", paged=True).decode(dq, pool, cfg)
    o_cuda = TB.resolve_backend("kernel", paged=True).decode(dq, pool, cfg)
    _close(o_cuda, o_ref.numpy())
    o_j, _ = jops.snapmla_decode_paged(
        *j_ops[:3], _jax_pool(pool), softmax_scale=SCALE, num_splits=num_splits,
        use_kernel=False)
    _close(o_ref, o_j)


def _jax_pool(pool: PagedMLAPool):
    from repro.core.kvcache import PagedMLAPool as JPool
    conv = {torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.bfloat16: jnp.bfloat16}
    out = []
    for x in pool:
        if x.dtype in conv:
            raw = x.view(torch.uint8 if x.dtype == torch.float8_e4m3fn else torch.int16)
            out.append(jnp.asarray(raw.numpy().view(conv[x.dtype])))
        else:
            out.append(jnp.asarray(x.numpy()))
    return JPool(*out)


def test_backend_registry_vocabulary():
    assert TB.backend_names() == ["cuda_paged_splitkv", "cuda_splitkv", "shard_map",
                                  "torch_paged_pipeline", "torch_paged_ref", "torch_pipeline",
                                  "torch_ref"]
    assert TB.resolve_backend("auto", paged=True).name == "torch_paged_ref"
    assert TB.resolve_backend("auto", paged=True, use_kernels=True).kind == "kernel"
    assert TB.resolve_backend("kernel", paged=False).name == "cuda_splitkv"
    with pytest.raises(ValueError, match="consumes a paged pool"):
        TB.resolve_backend("cuda_paged_splitkv", paged=False)
    with pytest.raises(ValueError, match="unknown decode backend"):
        TB.get_backend("pallas_paged_splitkv")


def test_wrappers_reject_mixed_devices_and_bad_dtypes():
    _, t_ops, _ = _setup("fp8_e4m3", lens=[5, 9], seed=5)
    meta = t_ops[:6] + (t_ops[6].to("meta"),) + t_ops[7:]
    with pytest.raises(ValueError, match="several devices"):
        TK.mla_decode_paged_cuda(*meta, softmax_scale=SCALE)
