"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (phase 2 of chip_smoke.py at small sizes): paged and contiguous
decode in both rescale modes, the sink guard, both combines, Fused-Q-Quant
and Fused-K-Append. Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on
the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.core.kvcache import (CacheConfig, MLACache, PagedMLAPool, init_mla_cache,
                                      mla_prefill, mla_quantize_entry)
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.kernels.mla_decode import ref as R
from repro_torch.kernels.quantize import kernel as QK
from repro_torch.kernels.quantize import ref as QR

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's AMLA kernel-vs-oracle gate (tests/test_parity.py:148-163)
AMLA_O, AMLA_LSE = dict(rtol=0.0, atol=1e-4), dict(rtol=0.0, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    _lib.lib()
    return torch.device("cuda")


def _case(fmt, lens, P, page, H, d_c, d_r, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, n_pool = len(lens), len(lens) * P + 2
    c = torch.randn(n_pool * page, d_c, generator=g, device="cuda")
    r = torch.randn(n_pool * page, d_r, generator=g, device="cuda") * 2
    content, rope, scale = mla_quantize_entry(CacheConfig(fmt=fmt, page_size=page), c, r)
    table = torch.randperm(n_pool, generator=g, device="cuda")[: B * P].reshape(B, P)
    pool = PagedMLAPool(content.reshape(n_pool, page, d_c), rope.reshape(n_pool, page, d_r),
                        scale.reshape(n_pool, page), table.int().contiguous(),
                        torch.tensor(lens, dtype=torch.int32, device="cuda"))
    q = R.prepare_q(torch.randn(B, H, d_c, generator=g, device="cuda"),
                    torch.randn(B, H, d_r, generator=g, device="cuda"), fmt)
    return tuple(t.contiguous() for t in q) + tuple(t.contiguous() for t in pool)


SHAPES = [(16, 4, 32, 16, 8), (128, 32, 512, 64, 4), (64, 12, 256, 32, 6)]


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("page,H,d_c,d_r,P", SHAPES)
def test_paged_splitkv_kernel_matches_plain(cuda, fmt, page, H, d_c, d_r, P):
    lens = [0, page, P * page - 5, page * P // 2 + 3]
    args = _case(fmt, lens, P, page, H, d_c, d_r)
    for S in (1, 2, 4):
        o, lse, (op, lp, sp) = K.mla_decode_paged_splitkv_cuda(
            *args, softmax_scale=0.1, num_splits=S, fmt=fmt, return_partials=True)
        o_r, lse_r, (op_r, lp_r, sp_r) = R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=0.1, num_splits=S, fmt=fmt, return_partials=True)
        torch.testing.assert_close(o, o_r, **TOL)
        torch.testing.assert_close(lse, lse_r, **TOL)
        torch.testing.assert_close(op, op_r, **TOL)
        torch.testing.assert_close(lp, lp_r, **TOL)
        torch.testing.assert_close(sp, sp_r, rtol=1e-6, atol=0.0)
        oc, lc = K.lse_combine_cuda(op, lp)
        oc_r, lc_r = R.lse_combine_ref(op, lp)
        torch.testing.assert_close(oc, oc_r, **TOL)
        torch.testing.assert_close(lc, lc_r, **TOL)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("page,H,d_c,d_r,P", SHAPES)
def test_single_pass_kernel_matches_plain_and_one_split(cuda, fmt, page, H, d_c, d_r, P):
    lens = [0, 1, P * page - 7, page + 9]
    args = _case(fmt, lens, P, page, H, d_c, d_r, seed=1)
    o, lse = K.mla_decode_paged_cuda(*args, softmax_scale=0.1, fmt=fmt)
    o_r, lse_r = R.snapmla_decode_paged_ref(*args, softmax_scale=0.1, fmt=fmt)
    torch.testing.assert_close(o, o_r, equal_nan=True, **TOL)
    torch.testing.assert_close(lse, lse_r, equal_nan=True, **TOL)
    live = torch.tensor([P * page, P * page - 1, (P - 1) * page + 1, P * page - 60 % page],
                        dtype=torch.int32, device="cuda")
    args_live = args[:7] + (live,)
    o_b, lse_b = K.mla_decode_paged_cuda(*args_live, softmax_scale=0.1, fmt=fmt)
    o_a, lse_a = K.mla_decode_paged_splitkv_cuda(*args_live, softmax_scale=0.1,
                                                 num_splits=1, fmt=fmt)
    assert torch.equal(o_b, o_a) and torch.equal(lse_b, lse_a)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B,H,d_c,d_r", [(1, 4, 32, 16), (4, 32, 512, 64), (3, 9, 96, 32)])
def test_fused_q_quant_kernel_bit_exact(cuda, fmt, B, H, d_c, d_r):
    g = torch.Generator(device="cuda").manual_seed(B + H)
    q = torch.randn(B, H, d_c + d_r, generator=g, device="cuda") * 4
    q[0, 0, :d_c] = 0.0
    for got, want in zip(QK.fused_q_quant_cuda(q, d_c, fmt=fmt),
                         QR.fused_q_quant_ref(q, d_c, fmt)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_launch_counts_and_rejections(cuda):
    args = _case("fp8_e4m3", [20, 40], 4, 16, 4, 32, 16)
    _lib.reset_launches()
    K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.1, num_splits=2)
    K.mla_decode_paged_cuda(*args, softmax_scale=0.1)
    assert _lib.LAUNCHES == {"paged_splitkv_decode": 1, "lse_combine": 1,
                             "paged_single_pass_decode": 1}
    with pytest.raises(ValueError, match="dtype"):
        K.mla_decode_paged_cuda(*args, softmax_scale=0.1, fmt="int8")
    with pytest.raises(ValueError, match="several devices"):
        K.mla_decode_paged_cuda(*args[:7], args[7].cpu(), softmax_scale=0.1)
    with pytest.raises(ValueError, match="num_splits"):
        K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.1, num_splits=5)
    contig = _contiguous(args, 4, 16)
    _lib.reset_launches()
    K.mla_decode_splitkv_cuda(*contig, softmax_scale=0.1, num_splits=2, block_n=16,
                              rescale="amla")
    K.mla_decode_cuda(*contig, softmax_scale=0.1, block_n=16)
    assert _lib.LAUNCHES == {"splitkv_decode_amla": 1, "amla_combine": 1,
                             "single_pass_decode": 1}
    with pytest.raises(ValueError, match="KV block"):
        K.mla_decode_cuda(*contig, softmax_scale=0.1, block_n=8)


def _contiguous(paged_args, P, page):
    """The contiguous cache [B, P*page, .] that a paged case's page table
    describes (block g of row b = pool page table[b, g])."""
    q_c8, q_r, sq, content, rope, scale, table, lens = paged_args
    B = table.shape[0]
    idx = table.long()
    return (q_c8, q_r, sq, content[idx].reshape(B, P * page, -1).contiguous(),
            rope[idx].reshape(B, P * page, -1).contiguous(),
            scale[idx].reshape(B, P * page).contiguous(), lens)


def _assert_equal(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("page,H,d_c,d_r,P", SHAPES)
def test_contiguous_kernels_match_plain_and_paged(cuda, fmt, rescale, page, H, d_c, d_r, P):
    """#2 and #1 against their plain versions; bit for bit against A and B at
    block_n == page (the same per-block code through another address), and
    #1 == #2 at one split when every block is live."""
    lens = [0, page, P * page - 5, page * P // 2 + 3]
    paged = _case(fmt, lens, P, page, H, d_c, d_r, seed=2)
    args = _contiguous(paged, P, page)
    o_tol, lse_tol = (AMLA_O, AMLA_LSE) if rescale == "amla" else (TOL, TOL)
    kw = dict(softmax_scale=0.1, fmt=fmt, rescale=rescale)
    for S in (1, 2, 4):
        o, lse, parts = K.mla_decode_splitkv_cuda(*args, num_splits=S, block_n=page,
                                                  return_partials=True, **kw)
        o_r, lse_r, parts_r = R.snapmla_decode_splitkv_ref(
            *args[:4], args[4].float(), *args[5:], num_splits=S, block_n=page,
            return_partials=True, **kw)
        torch.testing.assert_close(o, o_r, equal_nan=True, **o_tol)
        torch.testing.assert_close(lse, lse_r, equal_nan=True, **lse_tol)
        o_a, lse_a, parts_a = K.mla_decode_paged_splitkv_cuda(*paged, num_splits=S,
                                                              return_partials=True, **kw)
        for x, y in zip((o, lse) + tuple(parts), (o_a, lse_a) + tuple(parts_a)):
            _assert_equal(x, y)
        if rescale == "amla":   # #4 on these raw partials against its plain version
            oc, lc = K.amla_combine_cuda(*parts)
            oc_r, lc_r = R.amla_combine_ref(*parts)
            torch.testing.assert_close(oc, oc_r, equal_nan=True, **TOL)
            torch.testing.assert_close(lc, lc_r, equal_nan=True, **TOL)
    o1, lse1 = K.mla_decode_cuda(*args, block_n=page, **kw)
    o1_r, lse1_r = R.snapmla_decode_pipeline_ref(*args[:4], args[4].float(), *args[5:],
                                                 block_n=page, **kw)
    torch.testing.assert_close(o1, o1_r, equal_nan=True, **o_tol)
    torch.testing.assert_close(lse1, lse1_r, equal_nan=True, **lse_tol)
    o_b, lse_b = K.mla_decode_paged_cuda(*paged, **kw)
    _assert_equal(o1, o_b)
    _assert_equal(lse1, lse_b)
    live = torch.tensor([P * page, P * page - 1, (P - 1) * page + 1, P * page - 60 % page],
                        dtype=torch.int32, device="cuda")
    args_live = args[:6] + (live,)
    o1, lse1 = K.mla_decode_cuda(*args_live, block_n=page, **kw)
    o2, lse2 = K.mla_decode_splitkv_cuda(*args_live, num_splits=1, block_n=page, **kw)
    _assert_equal(o1, o2)
    _assert_equal(lse1, lse2)


@pytest.mark.parametrize("S_k", [4, 20])
@pytest.mark.parametrize("rescale", ["fma", "amla"])
def test_sink_guard_kernels_match_plain(cuda, S_k, rescale):
    """Rows below S_k read sink / max(scale, tiny) in float32; the float64 QK
    sum of those rows is not exact in every order, so a sink row's logit may
    differ from the plain version's by an ulp — within the gates here."""
    B, N, H, d_c, d_r, bn = 3, 96, 4, 32, 16, 16
    cfg = CacheConfig(fmt="fp8_e4m3", page_size=bn, sink_tokens=S_k)
    g = torch.Generator(device="cuda").manual_seed(3)
    cache = init_mla_cache(cfg, B, N, d_c, d_r, device="cuda")
    cache = mla_prefill(cache, cfg, torch.randn(B, 70, d_c, generator=g, device="cuda"),
                        torch.randn(B, 70, d_r, generator=g, device="cuda") * 2)
    cache = cache._replace(seq_lens=torch.tensor([70, 3, 41], dtype=torch.int32,
                                                 device="cuda"))
    q = tuple(t.contiguous() for t in R.prepare_q(
        torch.randn(B, H, d_c, generator=g, device="cuda"),
        torch.randn(B, H, d_r, generator=g, device="cuda"), "fp8_e4m3"))
    o_tol, lse_tol = (AMLA_O, AMLA_LSE) if rescale == "amla" else (TOL, TOL)
    from repro_torch.core.kvcache import sink_patched_content
    ref_args = q + (sink_patched_content(cache), cache.rope.float(), cache.scale,
                    cache.seq_lens)
    args = q + (cache.content, cache.rope, cache.scale, cache.seq_lens)
    kw = dict(softmax_scale=0.1, block_n=bn, rescale=rescale)
    for S in (1, 3):
        o, lse = K.mla_decode_splitkv_cuda(*args, num_splits=S, sink=cache.sink, **kw)
        o_r, lse_r = R.snapmla_decode_splitkv_ref(*ref_args, num_splits=S, **kw)
        torch.testing.assert_close(o, o_r, **o_tol)
        torch.testing.assert_close(lse, lse_r, **lse_tol)
    o, lse = K.mla_decode_cuda(*args, sink=cache.sink, **kw)
    o_r, lse_r = R.snapmla_decode_pipeline_ref(*ref_args, **kw)
    torch.testing.assert_close(o, o_r, **o_tol)
    torch.testing.assert_close(lse, lse_r, **lse_tol)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
def test_fused_k_append_kernel_bit_exact_and_equals_prefill(cuda, fmt):
    from repro_torch.kernels.quantize.ops import fused_k_append
    B, N, d_c, d_r, S = 3, 64, 512, 64, 40
    cfg = CacheConfig(fmt=fmt, page_size=16, sink_tokens=4)
    g = torch.Generator(device="cuda").manual_seed(4)
    c = torch.randn(B, S, d_c, generator=g, device="cuda") * 2
    r = torch.randn(B, S, d_r, generator=g, device="cuda") * 20
    c[1, 5] = 0.0                                    # the EPS floor
    bulk = mla_prefill(init_mla_cache(cfg, B, N, d_c, d_r, device="cuda"), cfg, c, r)
    inc = init_mla_cache(cfg, B, N, d_c, d_r, device="cuda")
    plain = init_mla_cache(cfg, B, N, d_c, d_r, device="cuda")
    for t in range(S):
        inc = fused_k_append(inc, c[:, t], r[:, t], fmt=fmt)
        plain = fused_k_append(plain, c[:, t], r[:, t], fmt=fmt, use_kernel=False)
    for a, b, w in zip(inc, plain, bulk):
        _assert_bytes(a, b)
        _assert_bytes(a, w)
    # past capacity: the row index is clamped to the last row
    full = inc._replace(seq_lens=torch.full((B,), N + 3, dtype=torch.int32, device="cuda"))
    ref = MLACache(*(x.clone() for x in full[:4]))
    k_args = (c[:, 0].contiguous(), r[:, 0].contiguous(), full.seq_lens)
    QK.fused_k_append_cuda(full.content, full.rope, full.scale, *k_args, fmt=fmt)
    QR.fused_k_append_ref(ref.content, ref.rope, ref.scale, *k_args, fmt=fmt)
    for a, b in zip(full[:3], ref[:3]):
        _assert_bytes(a, b)


def _assert_bytes(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _verify_case(fmt, lens, P, page, q_len, H, d_c, d_r, seed=0):
    """A paged case whose query is a [B, q_len, H, .] verify block."""
    base = _case(fmt, lens, P, page, q_len * H, d_c, d_r, seed)
    B = len(lens)
    q = (base[0].reshape(B, q_len, H, d_c), base[1].reshape(B, q_len, H, d_r),
         base[2].reshape(B, q_len, H))
    return q + base[3:]


def _assert_verify_close(got, want, rescale):
    o, lse = got
    o_r, lse_r = want
    # rows with no valid token: NaN (AMLA: 0 / 0) or 0 in both
    if rescale == "amla":
        torch.testing.assert_close(o, o_r, equal_nan=True, **AMLA_O)
        torch.testing.assert_close(lse, lse_r, equal_nan=True, **AMLA_LSE)
    else:
        torch.testing.assert_close(o, o_r, equal_nan=True, **TOL)
        torch.testing.assert_close(lse, lse_r, equal_nan=True, **TOL)


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("q_len", [2, 5])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "none"])
def test_verify_kernel_matches_plain_and_rows(cuda, rescale, q_len, fmt):
    """The q_len > 1 mode of A and #2 at H = 4 (a tile of 8 rows straddles two
    positions): against the plain version, row t bitwise equal to a q_len = 1
    launch at its limit, contiguous bitwise equal to paged, and a rank-4
    q_len = 1 block bitwise equal to the rank-3 launch. One slot is shorter
    than q_len (rows with limit <= 0)."""
    page, H, d_c, d_r, P = 16, 4, 32, 16, 6
    lens = [q_len - 1, page + 3, P * page - 2, 2 * page]
    args = _verify_case(fmt, lens, P, page, q_len, H, d_c, d_r, seed=q_len)
    contig = _contiguous(args, P, page)
    kw = dict(softmax_scale=0.1, fmt=fmt, rescale=rescale)
    for S in (1, 2, 4):
        _lib.reset_launches()
        o, lse, parts = K.mla_decode_paged_splitkv_cuda(*args, num_splits=S,
                                                        return_partials=True, **kw)
        suffix = "_amla" if rescale == "amla" else ""
        assert _lib.LAUNCHES[f"paged_splitkv_decode_verify{suffix}"] == 1
        assert o.shape == (4, q_len, H, d_c) and lse.shape == (4, q_len, H)
        assert parts[0].shape == (4, S, q_len, H, d_c)
        o_r, lse_r, parts_r = R.snapmla_decode_paged_splitkv_ref(
            *args, num_splits=S, return_partials=True, **kw)
        _assert_verify_close((o, lse), (o_r, lse_r), rescale)
        if rescale == "amla":
            _assert_equal(parts[2], parts_r[2])           # grid exponents g
        oc, lc = K.mla_decode_splitkv_cuda(*contig, num_splits=S, block_n=page, **kw)
        _assert_equal(oc, o)
        _assert_equal(lc, lse)
        for t in range(q_len):
            row_lens = torch.clamp(args[7] - (q_len - 1 - t), min=0).int()
            o1, l1 = K.mla_decode_paged_splitkv_cuda(
                args[0][:, t].contiguous(), args[1][:, t].contiguous(),
                args[2][:, t].contiguous(), *args[3:7], row_lens, num_splits=S, **kw)
            live = row_lens > 0
            _assert_equal(o[live, t], o1[live])
            _assert_equal(lse[live, t], l1[live])
    q1 = tuple(a[:, :1].contiguous() for a in args[:3])
    o4, l4 = K.mla_decode_paged_splitkv_cuda(*q1, *args[3:], num_splits=2, **kw)
    o3, l3 = K.mla_decode_paged_splitkv_cuda(*(a[:, 0] for a in q1), *args[3:],
                                             num_splits=2, **kw)
    _assert_equal(o4[:, 0], o3)
    _assert_equal(l4[:, 0], l3)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_fetch_dequant_kernel_bit_exact(cuda, fmt):
    """K1 in full, bounded and contiguous mode: bitwise against the plain
    version, dead pages all zero."""
    from repro_torch.kernels.quantize import fetch_dequant as FD
    page, d_c, d_r, P = 16, 32, 16, 5
    args = _case(fmt, [3, 40, 80], P, page, 4, d_c, d_r, seed=7)
    pool = PagedMLAPool(*args[3:])
    _lib.reset_launches()
    _assert_bytes(FD.paged_fetch_dequant(pool), FD.paged_fetch_dequant_ref(pool))
    for cs in ([0, 8, 16], [16, 79, 80], [5, 33, 1]):
        cs = torch.tensor(cs, dtype=torch.int32, device="cuda")
        got = FD.paged_fetch_dequant(pool, chunk_start=cs)
        _assert_bytes(got, FD.paged_fetch_dequant_ref(pool, chunk_start=cs))
        for b in range(3):
            dead = -(-int(cs[b]) // page) * page
            assert torch.count_nonzero(got[b, dead:]) == 0
    contig = _contiguous(args, P, page)
    cache = MLACache(*contig[3:6], args[7])
    _assert_bytes(FD.fetch_dequant(cache, page=page), FD.fetch_dequant_ref(cache))
    assert _lib.LAUNCHES == {"paged_fetch_dequant": 4, "fetch_dequant": 1}
