"""The port's q_len > 1 verify decode (plain version of the verify mode of the
CUDA kernels #6 / #2) and the engine's model steps against the JAX package:

  * the rank-4 plain versions (contiguous and paged, FMA and AMLA, 1/2/4
    splits) against the JAX Pallas kernels in interpret mode on the same
    cache bytes, rtol = atol = 1e-5 (AMLA within the reference's AMLA gates,
    tests/test_parity.py:148-163), rows whose limit is <= 0 masked (the JAX
    oracles give NaN there, the port's versions 0);
  * a rank-4 q_len = 1 block bitwise equal to the rank-3 call, row t bitwise
    equal to a q_len = 1 decode at its limit, paged bitwise equal to
    contiguous (tests/test_qlen_verify.py's contracts);
  * ``chunked_prefill`` and ``verify_step`` of the port against JAX on
    bridged weights of the mla-7b smoke config: logits within rtol = atol =
    1e-4 (tests/test_torch_model.py's gate); outside the scratch page 0 the
    pools' content and rope bytes identical, their scales within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import kvcache as jkv
from repro.kernels.mla_decode import ref as JR
from repro.kernels.mla_decode.kernel import (mla_decode_paged_splitkv_pallas,
                                             mla_decode_splitkv_pallas)
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import kvcache as tkv
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import kernel as TK
from repro_torch.kernels.mla_decode import ref as TR
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

SCALE = 0.1
Q, H, D_C, D_R, BN = 4, 4, 32, 16, 32
# shorter than q_len (rows with limit <= 0), == q_len, mid-block, full
LENS = [2, Q, 77, 130, 256]
TOL = dict(rtol=1e-5, atol=1e-5)
AMLA_O, AMLA_LSE = dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=["fp8_e4m3", "none"])
def case(request):
    """A JAX cache (contiguous) and its shuffled page pool, a rank-4 query,
    and the port's twins of both (the same bytes)."""
    fmt = request.param
    rng = np.random.RandomState(0)
    B, N = len(LENS), 256
    cfg = jkv.CacheConfig(fmt=fmt, page_size=BN)
    cache = jkv.mla_prefill(jkv.init_mla_cache(cfg, B, N, D_C, D_R), cfg,
                            jnp.asarray(rng.standard_normal((B, N, D_C)).astype(np.float32)),
                            jnp.asarray(rng.standard_normal((B, N, D_R)).astype(np.float32) * 2))
    cache = cache._replace(seq_lens=jnp.asarray(LENS, jnp.int32))
    q = rng.standard_normal((B, Q * H, D_C)).astype(np.float32)
    qr = rng.standard_normal((B, Q * H, D_R)).astype(np.float32)
    q8, qrf, sq = jax.jit(JR.prepare_q, static_argnums=2)(q, qr, fmt)
    q4 = (q8.reshape(B, Q, H, D_C), qrf.reshape(B, Q, H, D_R), sq.reshape(B, Q, H))
    P = N // BN
    perm = rng.permutation(B * P + 3)[: B * P].reshape(B, P).astype(np.int32)
    pool = jkv.init_paged_mla_pool(cfg, B * P + 3, P, B, D_C, D_R)._replace(
        page_table=jnp.asarray(perm), seq_lens=cache.seq_lens)
    for name in ("content", "rope", "scale"):
        src = getattr(cache, name)
        dst = getattr(pool, name).at[perm.reshape(-1)].set(
            src.reshape((B * P, BN) + src.shape[2:]))
        pool = pool._replace(**{name: dst})
    np_tree = jax.tree.map(np.asarray, (q4, cache, pool))
    tq = tuple(bridge.to_torch(x) for x in np_tree[0])
    return fmt, q4, cache, pool, tq, bridge.cache_from_jax(np_tree[1]), \
        bridge.pool_from_jax(np_tree[2])


def _live_rows():
    """[B, Q] mask of rows whose limit seq_len - (Q-1) + t is > 0."""
    lens = np.asarray(LENS)[:, None]
    return (lens - (Q - 1) + np.arange(Q)[None, :]) > 0


def _close(got, want, rescale):
    o, lse = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in got)
    o_r, lse_r = (np.asarray(x) for x in want)
    live = _live_rows()
    o_tol, lse_tol = (AMLA_O, AMLA_LSE) if rescale == "amla" else (TOL, TOL)
    np.testing.assert_allclose(o[live], o_r[live], **o_tol)
    np.testing.assert_allclose(lse[live], lse_r[live], **lse_tol)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_qlen_plain_versions_match_jax_kernels(case, rescale, splits):
    fmt, q4, cache, pool, tq, tcache, tpool = case
    kw = dict(softmax_scale=SCALE, num_splits=splits, fmt=fmt, rescale=rescale)
    want_c = mla_decode_splitkv_pallas(
        *q4, cache.content, cache.rope.astype(jnp.float32), cache.scale, cache.seq_lens,
        block_n=BN, **kw)
    want_p = mla_decode_paged_splitkv_pallas(
        *q4, pool.content, pool.rope.astype(jnp.float32), pool.scale, pool.page_table,
        pool.seq_lens, **kw)
    _lib.reset_launches()
    got_c = TK.mla_decode_splitkv_cuda(*tq, tcache.content, tcache.rope, tcache.scale,
                                       tcache.seq_lens, block_n=BN, **kw)
    got_p = TK.mla_decode_paged_splitkv_cuda(*tq, *tpool, **kw)
    assert sum(_lib.LAUNCHES.values()) == 0       # CPU tensors: the plain versions
    assert got_p[0].shape == (len(LENS), Q, H, D_C) and got_p[1].shape == (len(LENS), Q, H)
    _close(got_c, want_c, rescale)
    _close(got_p, want_p, rescale)
    for a, b in zip(got_c, got_p):                 # paged == contiguous, bit for bit
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("splits", [1, 2])
def test_qlen1_rank4_equals_rank3_and_rows_equal_sequential(case, splits):
    fmt, _, _, _, tq, _, tpool = case
    kw = dict(softmax_scale=SCALE, num_splits=splits, fmt=fmt)
    o4, l4 = TK.mla_decode_paged_splitkv_cuda(*(x[:, :1] for x in tq), *tpool, **kw)
    o3, l3 = TK.mla_decode_paged_splitkv_cuda(*(x[:, 0] for x in tq), *tpool, **kw)
    assert o4.shape == (len(LENS), 1, H, D_C)
    assert torch.equal(o4[:, 0].view(torch.int32), o3.view(torch.int32))
    assert torch.equal(l4[:, 0].view(torch.int32), l3.view(torch.int32))
    o, lse = TK.mla_decode_paged_splitkv_cuda(*tq, *tpool, **kw)
    for t in range(Q):
        lens_t = torch.clamp(tpool.seq_lens - (Q - 1 - t), min=0).int()
        o_t, l_t = TK.mla_decode_paged_splitkv_cuda(*(x[:, t] for x in tq), *tpool[:4],
                                                    lens_t, **kw)
        assert torch.equal(o_t.view(torch.int32), o[:, t].view(torch.int32)), t
        assert torch.equal(l_t.view(torch.int32), lse[:, t].view(torch.int32)), t


def test_rank4_takes_the_split_path_and_backends_accept_it(case):
    """ops / backends: a rank-4 query always takes the split-KV path, even at
    one split; DecodeQuery reports its q_len."""
    fmt, _, _, _, tq, _, tpool = case
    q = TB.DecodeQuery(*tq)
    assert q.q_len == Q and TB.DecodeQuery(*(x[:, 0] for x in tq)).q_len == 1
    bcfg = TB.BackendConfig(softmax_scale=SCALE, fmt=fmt, num_splits=1)
    # the kernel backend: the split-KV pipeline; the reference backend: the
    # parallel form on the gathered pages, row by row (backends.py:204-218)
    gathered = TR.gather_paged_view(*tpool[:4])
    wants = {
        "cuda_paged_splitkv": TR.snapmla_decode_paged_splitkv_ref(
            *tq, *tpool, softmax_scale=SCALE, num_splits=1, fmt=fmt)[0],
        "torch_paged_ref": TR.snapmla_decode_parallel_any(
            *tq, gathered[0], gathered[1].float(), gathered[2], tpool.seq_lens,
            softmax_scale=SCALE, num_splits=1, block_n=tpool.page_size, fmt=fmt)[0]}
    for name, want in wants.items():
        backend = TB.resolve_backend(name, paged=True, q_len=Q)
        o = backend.decode(q, tpool, bcfg)
        assert torch.equal(o.view(torch.int32), want.view(torch.int32))


def test_dispatch_cost_matches_jax():
    from repro.kernels.mla_decode import backends as JB
    for fmt in ("fp8_e4m3", "none"):
        assert TB.token_cost(fmt, 512, 64, 32) == JB.token_cost(fmt, 512, 64, 32)
    for jname, tname in (("jnp_paged_ref", "torch_paged_ref"),
                         ("pallas_paged_splitkv", "cuda_paged_splitkv")):
        j = JB.dispatch_cost(jname, tokens_visited=700, tokens_full=2048, heads=4, d_c=32,
                             d_r=16, fmt="fp8_e4m3")
        t = TB.dispatch_cost(tname, tokens_visited=700, tokens_full=2048, heads=4, d_c=32,
                             d_r=16, fmt="fp8_e4m3")
        for k in ("bytes", "bytes_min", "flops", "achieved_fraction"):
            assert t[k] == j[k], k


# ---------------------------------------------------------------------------
# model level: chunked_prefill and verify_step on bridged weights
# ---------------------------------------------------------------------------

B, SPAN = 2, 4            # slots, pages per slot (page 16: 64 tokens)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_smoke("mla-7b"), kv_paged=True, kv_pool_pages=B * SPAN + 1,
                               decode_backend="kernel", use_kernels=True)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), kv_paged=True, kv_pool_pages=B * SPAN + 1,
                               decode_backend="kernel", use_kernels=True)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    table = (1 + np.arange(B * SPAN, dtype=np.int32)).reshape(B, SPAN)[:, ::-1].copy()
    return jcfg, tcfg, jparams, tparams, table


def _j_with_tables(state, table, lens):
    return jax.tree.map(
        lambda p: jkv.pool_with_tables(p, table, lens) if isinstance(p, jkv.PagedMLAPool)
        else p, state, is_leaf=lambda x: isinstance(x, jkv.PagedMLAPool))


def _t_with_tables(state, table, lens):
    return {**state, "layers": [tkv.pool_with_tables(p, table, lens) for p in state["layers"]]}


def _j_layers(state):
    """The JAX state's per-layer pools (scanned superblocks unstacked)."""
    stacked = state["scanned"][0]
    n = stacked.content.shape[0]
    return [jax.tree.map(lambda a: np.asarray(a)[i], stacked) for i in range(n)]


def _assert_pools_close(tstate, jstate):
    """Pools outside the scratch page 0: fp8 content and bf16 rope bytes
    identical; the float32 scales within 1e-6 — they are max|c_kv| / 448 of
    projections that PyTorch's and XLA's CPU matmuls round a last bit apart
    (with equal inputs the bytes are equal: test_torch_fetch_dequant.py)."""
    for tp, jp in zip(tstate["layers"], _j_layers(jstate)):
        jt = bridge.pool_from_jax(jp)
        assert torch.equal(tp.content[1:].view(torch.uint8), jt.content[1:].view(torch.uint8))
        assert torch.equal(tp.rope[1:].view(torch.int16), jt.rope[1:].view(torch.int16))
        np.testing.assert_allclose(tp.scale[1:].numpy(), jt.scale[1:].numpy(), rtol=1e-6,
                                   atol=0)


def _prompts(jcfg, n):
    return np.random.RandomState(3).randint(0, jcfg.vocab_size, (B, n)).astype(np.int32)


def test_chunked_prefill_matches_jax(model):
    """Three chunks of 16 (the last padded to its bucket) through both
    stacks: each chunk's logits within 1e-4, the pools alike."""
    jcfg, tcfg, jparams, tparams, table = model
    prompts = _prompts(jcfg, 40)
    jstate = JT.init_decode_state(jcfg, B, SPAN * 16)
    tstate = TT.init_decode_state(tcfg, B, SPAN * 16, device="cpu")
    jstep = jax.jit(jsteps.make_chunked_prefill_step(jcfg))
    tstep = tsteps.make_chunked_prefill_step(tcfg)
    for start in (0, 16, 32):
        width = min(16, 40 - start)
        bucket = tsteps.bucket_for(width, 16)
        assert bucket == jsteps.bucket_for(width, 16)
        tok = np.zeros((B, bucket), np.int32)
        tok[:, :width] = prompts[:, start:start + width]
        lens = np.full((B,), start, np.int32)
        last = np.full((B,), width - 1, np.int32)
        jl, jstate = jstep(jparams, jnp.asarray(tok), _j_with_tables(jstate, table, lens),
                           jnp.asarray(lens), jnp.asarray(last))
        tl, tstate = tstep(tparams, _t(tok).long(), _t_with_tables(tstate, table, lens),
                           _t(lens), _t(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tstate["layers"][0].seq_lens.numpy(), lens + width)
    _assert_pools_close(tstate, jstate)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
def test_verify_step_matches_jax(model, rescale):
    """A prefill of 30 tokens, then one verify block of K = 4 at start 30 on
    both stacks: logits of every position within 1e-4, the pools alike."""
    jcfg, tcfg, jparams, tparams, table = model
    jcfg = dataclasses.replace(jcfg, kv_rescale=rescale)
    tcfg = dataclasses.replace(tcfg, kv_rescale=rescale)
    prompts = _prompts(jcfg, 30)
    jstate = JT.init_decode_state(jcfg, B, SPAN * 16)
    tstate = TT.init_decode_state(tcfg, B, SPAN * 16, device="cpu")
    zeros = np.zeros((B,), np.int32)
    _, jstate = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, jnp.asarray(prompts), _j_with_tables(jstate, table, zeros))
    _, tstate = TT.prefill(tparams, tcfg, _t(prompts).long(),
                           _t_with_tables(tstate, table, zeros))
    draft = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, 4)).astype(np.int32)
    start = np.full((B,), 30, np.int32)
    jl, jstate = jax.jit(jsteps.make_verify_step(jcfg))(
        jparams, jnp.asarray(draft), _j_with_tables(jstate, table, start), jnp.asarray(start))
    tl, tstate = tsteps.make_verify_step(tcfg)(
        tparams, _t(draft), _t_with_tables(tstate, table, start), _t(start))
    assert tl.shape == (B, 4, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _assert_pools_close(tstate, jstate)
    # the reference-backend twin: the parallel form, which has no AMLA, as
    # the reference's jnp_paged_ref twin
    rl, _ = tsteps.make_verify_step(tcfg, ref=True)(
        tparams, _t(draft), _t_with_tables(tstate, table, start), _t(start))
    jref = dataclasses.replace(jcfg, decode_backend="ref", use_kernels=False)
    jrl, _ = jax.jit(jsteps.make_verify_step(jref))(
        jparams, jnp.asarray(draft), _j_with_tables(jstate, table, start), jnp.asarray(start))
    np.testing.assert_allclose(rl.numpy(), np.asarray(jrl), rtol=1e-4, atol=1e-4)


def test_verify_row_equals_decode_step(model):
    """verify_step with K = 1 is the ordinary decode step (the same entry
    appended, one query row): the port's logits agree bit for bit."""
    _, tcfg, _, tparams, table = model
    jcfg = j_smoke("mla-7b")
    prompts = _prompts(jcfg, 20)
    states = []
    for _ in range(2):
        st = TT.init_decode_state(tcfg, B, SPAN * 16, device="cpu")
        _, st = TT.prefill(tparams, tcfg, _t(prompts).long(),
                           _t_with_tables(st, table, np.zeros((B,), np.int32)))
        states.append(st)
    start = np.full((B,), 20, np.int32)
    tok = np.asarray([5, 9], np.int32)
    vl, _ = TT.verify_step(tparams, tcfg, _t(tok[:, None]),
                           _t_with_tables(states[0], table, start), _t(start))
    dl, _ = TT.decode_step(tparams, tcfg, _t(tok), _t_with_tables(states[1], table, start),
                           _t(start))
    np.testing.assert_allclose(vl[:, 0].numpy(), dl.numpy(), rtol=1e-6, atol=1e-6)
