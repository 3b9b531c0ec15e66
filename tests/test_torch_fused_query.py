"""The raw decode query (Fused-Q-Quant folded into the decode kernels'
prologue) and the combine routing of the decode wrappers, on the CPU:

  * the kernel backends given ``DecodeQuery.raw(q_lat, q_rope)`` return what
    they return for the query ``prepare_q`` makes, bit for bit, at mla-7b's
    smoke width, rank 3 and rank 4, paged and contiguous (on CPU tensors a
    raw query runs ``fused_q_quant_ref`` and then the plain version); so do
    the reference backends, which prepare it with ``prepare_q``;
  * the wrappers on a raw query against the JAX package's
    ``fused_q_quant_pallas`` (interpret mode) followed by its Pallas decode
    kernels (interpret mode) on the same cache bytes, within the 1e-5 of
    tests/test_torch_mla_decode.py and tests/test_torch_qlen_verify.py;
  * ``kernel.launch_plan``, the rule that routes a call to the folded
    launch (C under FMA, #4 under AMLA, in the split kernel's epilogue), or,
    for a caller that keeps the partials, to the kernel then C or #4.

That the folded launch gives the unfolded launches' bits is checked on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.kernels.mla_decode.kernel import (mla_decode_paged_pallas,
                                             mla_decode_paged_splitkv_pallas,
                                             mla_decode_splitkv_pallas)
from repro.kernels.quantize.kernel import fused_q_quant_pallas
from repro_torch import bridge
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import kernel as TK
from repro_torch.kernels.mla_decode import ref as TR
from repro_torch.models import transformer as TT

SCALE = 0.1
# mla-7b's smoke width (configs: 4 heads, d_c 32, d_rope 16, page 16)
H, D_C, D_R, BN, Q = 4, 32, 16, 16, 3
LENS = [3, 16, 37, 64, 90]    # every verify row has a valid token
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["fp8_e4m3", "int8"])
def case(request):
    """A JAX-quantized cache, contiguous and as a shuffled page pool, a raw
    [B, Q, H, .] query block, and the port's twins of all of them."""
    fmt = request.param
    rng = np.random.RandomState(7)
    B, N = len(LENS), 96
    cfg = jkv.CacheConfig(fmt=fmt, page_size=BN)
    cache = jax.jit(jkv.mla_prefill, static_argnums=1)(
        jkv.init_mla_cache(cfg, B, N, D_C, D_R), cfg,
        rng.standard_normal((B, N, D_C)).astype(np.float32),
        (rng.standard_normal((B, N, D_R)) * 2).astype(np.float32))
    cache = cache._replace(seq_lens=jnp.asarray(LENS, jnp.int32))
    P = N // BN
    perm = rng.permutation(B * P + 3)[: B * P].reshape(B, P).astype(np.int32)
    pool = jkv.init_paged_mla_pool(cfg, B * P + 3, P, B, D_C, D_R)._replace(
        page_table=jnp.asarray(perm), seq_lens=cache.seq_lens)
    for name in ("content", "rope", "scale"):
        src = getattr(cache, name)
        pool = pool._replace(**{name: getattr(pool, name).at[perm.reshape(-1)].set(
            src.reshape((B * P, BN) + src.shape[2:]))})
    q_lat = (rng.standard_normal((B, Q, H, D_C)) * 3).astype(np.float32)
    q_rope = rng.standard_normal((B, Q, H, D_R)).astype(np.float32)
    q_lat[0, 0, 0] = 0.0                      # the EPS floor of sigma_q
    np_cache, np_pool = jax.tree.map(np.asarray, (cache, pool))
    return dict(fmt=fmt, cache=cache, pool=pool, q_lat=q_lat, q_rope=q_rope,
                tcache=bridge.cache_from_jax(np_cache), tpool=bridge.pool_from_jax(np_pool))


def _query(case, rank):
    """The raw (q_lat, q_rope) of rank 3 (the block's last row) or 4."""
    q_lat, q_rope = case["q_lat"], case["q_rope"]
    if rank == 3:
        q_lat, q_rope = q_lat[:, -1], q_rope[:, -1]
    return torch.from_numpy(np.ascontiguousarray(q_lat)), \
        torch.from_numpy(np.ascontiguousarray(q_rope))


def _jax_prepared(case, rank):
    """JAX's Fused-Q-Quant kernel (interpret mode) on the raw query."""
    q_lat, q_rope = (x.numpy() for x in _query(case, rank))
    lead = q_lat.shape[:-1]
    flat = np.concatenate([q_lat, q_rope], -1).reshape(lead[0], -1, D_C + D_R)
    q8, qr, sq = fused_q_quant_pallas(jnp.asarray(flat), D_C, fmt=case["fmt"])
    return q8.reshape(*lead, D_C), qr.reshape(*lead, D_R), sq.reshape(lead)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("rank", [3, 4])
def test_raw_query_equals_prepared_query_on_every_backend(case, rank, layout, splits):
    fmt = case["fmt"]
    q_lat, q_rope = _query(case, rank)
    prepared = TB.DecodeQuery(*TR.prepare_q(q_lat, q_rope, fmt))
    raw = TB.DecodeQuery.raw(q_lat, q_rope)
    assert raw.sigma_q is None and raw.q_len == prepared.q_len == (Q if rank == 4 else 1)
    paged = layout == "paged"
    cache = case["tpool"] if paged else case["tcache"]
    cfg = TB.BackendConfig(softmax_scale=SCALE, block_n=BN, fmt=fmt, num_splits=splits)
    _lib.reset_launches()
    for kind in ("kernel", "ref"):
        backend = TB.resolve_backend(kind, paged=paged)
        want = backend.decode(prepared, cache, cfg)
        got = backend.decode(raw, cache, cfg)
        assert got.shape == q_lat.shape and torch.isfinite(got).all()
        assert _bits_equal(got, want), kind
    assert sum(_lib.LAUNCHES.values()) == 0     # CPU tensors: the plain versions


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("rank", [3, 4])
def test_raw_query_wrappers_match_jax_q_quant_then_pallas_decode(case, rank, splits):
    fmt = case["fmt"]
    cache, pool = case["cache"], case["pool"]
    tcache, tpool = case["tcache"], case["tpool"]
    q_lat, q_rope = _query(case, rank)
    jq = _jax_prepared(case, rank)
    kw = dict(softmax_scale=SCALE, num_splits=splits, fmt=fmt)
    want_p = mla_decode_paged_splitkv_pallas(
        *jq, pool.content, pool.rope.astype(jnp.float32), pool.scale, pool.page_table,
        pool.seq_lens, **kw)
    want_c = mla_decode_splitkv_pallas(
        *jq, cache.content, cache.rope.astype(jnp.float32), cache.scale, cache.seq_lens,
        block_n=BN, **kw)
    got_p = TK.mla_decode_paged_splitkv_cuda(q_lat, q_rope, None, *tpool, **kw)
    got_c = TK.mla_decode_splitkv_cuda(q_lat, q_rope, None, tcache.content, tcache.rope,
                                       tcache.scale, tcache.seq_lens, block_n=BN, **kw)
    pairs = [(got_p, want_p), (got_c, want_c)]
    if rank == 3 and splits == 1:   # the single pass (B / #1 with D in the prologue)
        pairs.append((TK.mla_decode_paged_cuda(q_lat, q_rope, None, *tpool,
                                               softmax_scale=SCALE, fmt=fmt),
                      mla_decode_paged_pallas(*jq, pool.content,
                                              pool.rope.astype(jnp.float32), pool.scale,
                                              pool.page_table, pool.seq_lens,
                                              softmax_scale=SCALE, fmt=fmt)))
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == tuple(np.asarray(w).shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for a, b in zip(got_p, got_c):      # paged == contiguous at block_n == page
        assert _bits_equal(a, b)


@pytest.mark.parametrize("raw,fmt,single_pass,rescale,return_partials,want", [
    (True, "fp8_e4m3", False, "fma", False, "folded"),
    (True, "int8", False, "fma", False, "folded"),
    (False, "none", False, "fma", False, "folded"),
    (True, "fp8_e4m3", False, "fma", True, "lse_combine"),
    (False, "fp8_e4m3", False, "fma", True, "lse_combine"),
    (True, "fp8_e4m3", False, "amla", False, "folded"),
    (False, "none", False, "amla", False, "folded"),
    (False, "none", False, "amla", True, "amla_combine"),
    (True, "int8", False, "amla", True, "amla_combine"),
    (True, "int8", True, "fma", False, "none"),
    (False, "none", True, "amla", False, "none"),
])
def test_launch_plan_routes_each_call(raw, fmt, single_pass, rescale, return_partials, want):
    assert TK.launch_plan(raw=raw, fmt=fmt, single_pass=single_pass, rescale=rescale,
                          return_partials=return_partials) == want


@pytest.mark.parametrize("rescale,num_splits,want", [
    ("amla", 8, "folded"), ("amla", TK.AMLA_FOLD_MAX_SPLITS, "folded"),
    ("amla", TK.AMLA_FOLD_MAX_SPLITS + 1, "amla_combine"),
    ("fma", TK.AMLA_FOLD_MAX_SPLITS + 1, "folded")])
def test_launch_plan_keeps_the_amla_fold_within_its_shift_table(rescale, num_splits, want):
    """#4 folds up to the split count whose shift table fits a CUDA block's
    shared memory (the .cu's kMaxAmlaFoldSplits); past it the kernel then
    the standalone #4 run it. C folds at any split count."""
    src = (_lib.CSRC / "mla_decode.cu").read_text()
    assert f"constexpr int kMaxAmlaFoldSplits = {TK.AMLA_FOLD_MAX_SPLITS};" in src
    assert TK.launch_plan(raw=True, fmt="fp8_e4m3", single_pass=False, rescale=rescale,
                          num_splits=num_splits) == want


def test_launch_plan_rejects_a_raw_none_query_and_unknown_modes(case):
    with pytest.raises(ValueError, match="raw query"):
        TK.launch_plan(raw=True, fmt="none", single_pass=False, rescale="fma")
    with pytest.raises(ValueError, match="rescale"):
        TK.launch_plan(raw=False, fmt="fp8_e4m3", single_pass=False, rescale="exp2")
    q_lat, q_rope = _query(case, 3)
    with pytest.raises(ValueError, match="raw query"):   # the wrappers apply the rule
        TK.mla_decode_paged_splitkv_cuda(q_lat, q_rope, None, *case["tpool"],
                                         softmax_scale=SCALE, num_splits=2, fmt="none")


@pytest.mark.parametrize("fmt,kind,is_raw", [
    ("fp8_e4m3", "kernel", True), ("int8", "kernel", True), ("none", "kernel", False),
    ("fp8_e4m3", "ref", False)])
def test_model_prepares_the_query_the_backend_takes(fmt, kind, is_raw):
    """``_prepare_query`` hands the kernel backends the raw query over an fp8
    / int8 cache and ``prepare_q``'s query otherwise, keeping its rank."""
    from repro_torch.core.kvcache import CacheConfig
    rng = np.random.RandomState(1)
    q_lat = torch.from_numpy(rng.standard_normal((2, Q, H, D_C)).astype(np.float32))
    q_rope = torch.from_numpy(rng.standard_normal((2, Q, H, D_R)).astype(np.float32))
    backend = TB.resolve_backend(kind, paged=True)
    q = TT._prepare_query(q_lat, q_rope, CacheConfig(fmt=fmt, page_size=BN), backend)
    assert (q.sigma_q is None) == is_raw and q.q_len == Q
    if is_raw:
        assert q.q_c8 is q_lat and q.q_r is q_rope
    else:
        for a, b in zip(q, TR.prepare_q(q_lat, q_rope, fmt)):
            assert a.dtype == b.dtype and torch.equal(a.float(), b.float())
