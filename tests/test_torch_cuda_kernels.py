"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (phase 2 of chip_smoke.py at small sizes): paged and contiguous
decode in both rescale modes, the sink guard, both combines, Fused-Q-Quant,
Fused-K-Append, the fetch-dequant kernel at every tokens-per-warp, the
q_len > 1 verify mode, the decode kernels with Fused-Q-Quant in their
prologue and C (FMA) or #4 (AMLA) in their epilogue against the launches they
replace, and the GQA decode (#7). Needs an NVIDIA
GPU and nvcc; skipped elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import contextlib

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
    with K.forced_design("exact"):   # A's exact design: B's bits at one split
        o_a, lse_a = K.mla_decode_paged_splitkv_cuda(*args_live, softmax_scale=0.1,
                                                     num_splits=1, fmt=fmt)
    assert torch.equal(o_b, o_a) and torch.equal(lse_b, lse_a)


D_SHAPES = [(1, 4, 32, 16), (4, 32, 512, 64), (3, 9, 96, 32), (4, 128, 512, 64),
            (64, 128, 512, 64), (3, 9, 512, 64), (2, 5, 512, 32)]


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is not 16-byte aligned."""
    one_byte = t.element_size() == 1
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8 if one_byte else t.dtype, device=t.device)
    out = buf[1:].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B,H,d_c,d_r", D_SHAPES)
def test_fused_q_quant_kernel_bit_exact(cuda, fmt, B, H, d_c, d_r):
    """D at the MLA widths and runtime widths (B x H not a multiple of the
    rows per block at (3, 9)), and on a view whose pointer is not 16-byte
    aligned (the runtime-width instantiation)."""
    g = torch.Generator(device="cuda").manual_seed(B + H)
    q = torch.randn(B, H, d_c + d_r, generator=g, device="cuda") * 4
    q[0, 0, :d_c] = 0.0
    want = QR.fused_q_quant_ref(q, d_c, fmt)
    for got, x in zip(QK.fused_q_quant_cuda(q, d_c, fmt=fmt), want):
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
    for got, x in zip(QK.fused_q_quant_cuda(_unaligned(q), d_c, fmt=fmt), want):
        assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B,N,d_c,d_r", [(4, 640, 512, 64), (64, 128, 512, 64),
                                         (3, 64, 96, 32), (5, 16, 32, 16), (2, 8, 512, 32)])
def test_fused_k_append_kernel_instantiations_bit_exact(cuda, fmt, B, N, d_c, d_r):
    """#9 at the MLA widths and runtime widths, aligned and on views whose
    pointers are not 16-byte aligned, with an EPS-floor row and a row past
    capacity (clamped to the last)."""
    g = torch.Generator(device="cuda").manual_seed(B * N)
    qdt = torch.float8_e4m3fn if fmt == "fp8_e4m3" else torch.int8
    cache = (torch.randint(-100, 100, (B, N, d_c), generator=g, device="cuda",
                           dtype=torch.int8).view(torch.uint8).view(qdt),
             torch.randn(B, N, d_r, generator=g, device="cuda").bfloat16(),
             torch.rand(B, N, generator=g, device="cuda"))
    c = torch.randn(B, d_c, generator=g, device="cuda") * 3
    r = torch.randn(B, d_r, generator=g, device="cuda") * 10
    c[0] = 0.0
    lens = torch.randint(0, N, (B,), generator=g, device="cuda", dtype=torch.int32)
    lens[-1] = N + 5
    want = [t.clone() for t in cache]
    QR.fused_k_append_ref(*want, c, r, lens, fmt=fmt)
    for copy in (torch.clone, _unaligned):
        got = [copy(t) for t in cache]
        QK.fused_k_append_cuda(*got, copy(c), copy(r), lens, fmt=fmt)
        for a, b in zip(got, want):
            _assert_bytes(a, b)


def test_token_prep_launch_counts_and_c_rejections(cuda):
    """D and #9 count one launch per wrapper call; their C entry points
    refuse the full-width instantiation at other widths or on a pointer that
    is not 16-byte aligned."""
    q = torch.randn(4, 32, 576, device="cuda")
    cache = init_mla_cache(CacheConfig(fmt="fp8_e4m3", page_size=16), 4, 32, 512, 64,
                           device="cuda")
    c, r = torch.randn(4, 512, device="cuda"), torch.randn(4, 64, device="cuda")
    _lib.reset_launches()
    QK.fused_q_quant_cuda(q, 512)
    QK.fused_k_append_cuda(cache.content, cache.rope, cache.scale, c, r, cache.seq_lens)
    QK.fused_q_quant_cuda(_unaligned(q), 512)
    assert _lib.LAUNCHES == {"fused_q_quant": 2, "fused_k_append": 1}
    lib, st = _lib.lib(), torch.cuda.current_stream().cuda_stream
    out = [torch.empty(4 * 32 * n, device="cuda") for n in (512, 64, 1)]
    ptrs = [t.data_ptr() for t in out]
    assert lib.snapmla_fused_q_quant(0, q.data_ptr(), *ptrs, 4, 32, 512, 64, 1, st) == 0
    assert lib.snapmla_fused_q_quant(0, q.data_ptr(), *ptrs, 4, 32, 480, 96, 1, st) != 0
    assert lib.snapmla_fused_q_quant(0, q.data_ptr() + 4, *ptrs, 4, 32, 512, 64, 1, st) != 0
    args = [t.data_ptr() for t in (c, r, cache.content, cache.rope, cache.scale,
                                   cache.seq_lens)]
    assert lib.snapmla_fused_k_append(0, *args, 4, 32, 512, 64, 1, st) == 0
    assert lib.snapmla_fused_k_append(0, *args, 4, 32, 256, 64, 1, st) != 0
    torch.cuda.synchronize()


def test_launch_counts_and_rejections(cuda):
    args = _case("fp8_e4m3", [20, 40], 4, 16, 4, 32, 16)
    _lib.reset_launches()
    K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.1, num_splits=2)   # C folded
    K.mla_decode_paged_cuda(*args, softmax_scale=0.1)
    assert _lib.LAUNCHES == {"paged_splitkv_decode": 1, "paged_single_pass_decode": 1}
    raw = tuple(torch.randn(2, 4, d, device="cuda") for d in (32, 16)) + (None,)
    _lib.reset_launches()
    K.mla_decode_paged_splitkv_cuda(*raw, *args[3:], softmax_scale=0.1, num_splits=2)
    K.mla_decode_paged_cuda(*raw, *args[3:], softmax_scale=0.1)   # D in the prologue
    K.mla_decode_paged_splitkv_cuda(*raw, *args[3:], softmax_scale=0.1, num_splits=2,
                                    return_partials=True)
    assert _lib.LAUNCHES == {"paged_splitkv_decode": 2, "paged_single_pass_decode": 1,
                             "lse_combine": 1}
    with pytest.raises(ValueError, match="raw query"):
        K.mla_decode_paged_cuda(*raw, *args[3:], softmax_scale=0.1, fmt="none")
    with pytest.raises(ValueError, match="q_lat"):
        K.mla_decode_paged_cuda(raw[0].half(), *raw[1:], *args[3:], softmax_scale=0.1)
    with pytest.raises(ValueError, match="dtype"):
        K.mla_decode_paged_cuda(*args, softmax_scale=0.1, fmt="int8")
    with pytest.raises(ValueError, match="several devices"):
        K.mla_decode_paged_cuda(*args[:7], args[7].cpu(), softmax_scale=0.1)
    with pytest.raises(ValueError, match="num_splits"):
        K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.1, num_splits=5)
    contig = _contiguous(args, 4, 16)
    _lib.reset_launches()
    K.mla_decode_splitkv_cuda(*contig, softmax_scale=0.1, num_splits=2, block_n=16,
                              rescale="amla")                           # #4 folded
    K.mla_decode_cuda(*contig, softmax_scale=0.1, block_n=16)
    assert _lib.LAUNCHES == {"splitkv_decode_amla": 1, "single_pass_decode": 1}
    K.mla_decode_splitkv_cuda(*contig, softmax_scale=0.1, num_splits=2, block_n=16,
                              rescale="amla", return_partials=True)      # #4 after it
    assert _lib.LAUNCHES == {"splitkv_decode_amla": 2, "amla_combine": 1,
                             "single_pass_decode": 1}
    with pytest.raises(ValueError, match="KV block"):
        K.mla_decode_cuda(*contig, softmax_scale=0.1, block_n=8)


def test_amla_combine_kernel_at_one_split_gives_the_pinned_bits(cuda):
    """#4's routine (amla_merge, which the folded AMLA epilogue's one-split
    path shares) on one split with -0 and subnormal acc entries, a subnormal
    l and a row with no token: the plain version's bits (pinned on the CPU by
    tests/test_torch_amla.py), NaN where both are NaN."""
    acc = torch.tensor([[[[1.5, -0.0, 1e-40, -3e-39, 2.0 ** -126, -7.25, 0.0, 3e38],
                          [0.5, -2.0, -0.0, 1e-44, 4.0, 1e-30, -1e-39, 2.5],
                          [0.0] * 8]]])
    l, g = torch.tensor([[[3.75, 1e-40, 0.0]]]), torch.tensor([[[-7.0, 12.0, 0.0]]])
    want = R.amla_combine_ref(acc, l, g)
    got = K.amla_combine_cuda(acc.cuda(), l.cuda(), g.cuda())
    for a, b in zip(got, want):
        a = a.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = (torch.where(torch.isnan(x), 7.0, x) for x in (a, b))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


WIDTH_SHAPES = [(16, 12, 96, 32, 6), (64, 12, 256, 32, 4), (128, 32, 512, 64, 3),
                (256, 9, 512, 64, 2)]


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("page,H,d_c,d_r,P", WIDTH_SHAPES)
def test_every_head_width_bitwise_equal_to_width_8(cuda, fmt, rescale, page, H, d_c, d_r, P):
    """The head-tile width decides only which CUDA block computes a head:
    every instantiated width gives width 8's bits in every mode — split and
    single pass, paged and contiguous, the q_len > 1 verify mode and the
    sink guard — on rows that are empty, ragged and full."""
    if fmt == "none" and page == 256:
        d_c = 256   # 256 bf16 rows of 512 do not fit one block's shared memory
    lens = [0, P * page - page // 2 - 3, P * page, 5]
    paged = _case(fmt, lens, P, page, H, d_c, d_r, seed=11)
    contig = _contiguous(paged, P, page)
    ver = _verify_case(fmt, lens, P, page, 3, H, d_c, d_r, seed=12)
    ver_contig = _contiguous(ver, P, page)
    kw = dict(softmax_scale=0.1, fmt=fmt, rescale=rescale)
    calls = []
    for S in (1, 2, P):
        calls += [lambda S=S: K.mla_decode_paged_splitkv_cuda(*paged, num_splits=S,
                                                              return_partials=True, **kw),
                  lambda S=S: K.mla_decode_splitkv_cuda(*contig, num_splits=S, block_n=page,
                                                        return_partials=True, **kw),
                  lambda S=S: K.mla_decode_paged_splitkv_cuda(*ver, num_splits=S,
                                                              return_partials=True, **kw),
                  lambda S=S: K.mla_decode_splitkv_cuda(*ver_contig, num_splits=S,
                                                        block_n=page, return_partials=True,
                                                        **kw)]
    calls += [lambda: K.mla_decode_paged_cuda(*paged, **kw),
              lambda: K.mla_decode_cuda(*contig, block_n=page, **kw)]
    if fmt == "fp8_e4m3":   # the sink guard (contiguous caches)
        sink = torch.randn(len(lens), 4, d_c, generator=torch.Generator(device="cuda")
                           .manual_seed(13), device="cuda")
        calls += [lambda: K.mla_decode_cuda(*contig, block_n=page, sink=sink, **kw),
                  lambda: K.mla_decode_splitkv_cuda(*contig, num_splits=2, block_n=page,
                                                    sink=sink, **kw)]

    def flat(x):
        return [t for y in x for t in flat(y)] if isinstance(x, tuple) else [x]

    for i, call in enumerate(calls):
        with K.forced_head_width(8):
            want = flat(call())
        for w in K.HEAD_WIDTHS[1:]:
            with K.forced_head_width(w):
                got = flat(call())
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a.contiguous().view(torch.uint8),
                                   b.contiguous().view(torch.uint8)), (i, w)


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
@pytest.mark.parametrize("page,d_c,d_r,lens,P,starts", [
    (16, 32, 16, [3, 40, 80], 5, ([0, 8, 16], [16, 79, 80], [5, 33, 1])),
    # B = 1 over 3 pages (3 blocks of one page each before the token slices)
    (16, 512, 64, [40], 3, ([0], [17], [48])),
    # pages of 10 and 6 tokens: not a multiple of any slice (4 x 1, 2 or 4)
    (10, 32, 16, [1, 27, 30], 3, ([0, 10, 11], [30, 5, 29])),
    (6, 64, 8, [5], 4, ([0], [7], [24]))])
def test_fetch_dequant_kernel_bit_exact(cuda, fmt, page, d_c, d_r, lens, P, starts):
    """K1 in full, bounded and contiguous mode, at every tokens per warp the
    kernel takes and at the pick of ``fetch_geometry``: bitwise against the
    plain version, dead pages all zero."""
    from repro_torch.kernels.quantize import fetch_dequant as FD
    B = len(lens)
    args = _case(fmt, lens, P, page, 4, d_c, d_r, seed=7 + page)
    pool = PagedMLAPool(*args[3:])
    contig = _contiguous(args, P, page)
    cache = MLACache(*contig[3:6], args[7])
    want_full = FD.paged_fetch_dequant_ref(pool)
    for tpw in (None,) + FD.TOKENS_PER_WARP:
        _lib.reset_launches()
        with FD.forced_tokens_per_warp(tpw) if tpw else contextlib.nullcontext():
            _assert_bytes(FD.paged_fetch_dequant(pool), want_full)
            for cs in starts:
                cs = torch.tensor(cs, dtype=torch.int32, device="cuda")
                got = FD.paged_fetch_dequant(pool, chunk_start=cs)
                _assert_bytes(got, FD.paged_fetch_dequant_ref(pool, chunk_start=cs))
                for b in range(B):
                    dead = -(-int(cs[b]) // page) * page
                    assert torch.count_nonzero(got[b, dead:]) == 0
            _assert_bytes(FD.fetch_dequant(cache, page=page), FD.fetch_dequant_ref(cache))
        assert _lib.LAUNCHES == {"paged_fetch_dequant": 1 + len(starts), "fetch_dequant": 1}


def _gqa_case(fmt, B, N, Hkv, g, dh, window, page, lens, seed=0):
    """A GQA cache on the card: each row prefilled with ``lens[b]`` tokens
    through the port's ring / linear prefill, and a query per row at
    position ``lens[b] - 1``."""
    from repro_torch.core.kvcache import GQACache, gqa_prefill, init_gqa_cache
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = CacheConfig(fmt=fmt, page_size=page, window=window)
    rows = []
    for n in lens:
        c = init_gqa_cache(cfg, 1, N, Hkv, dh, device="cuda")
        if n:
            c = gqa_prefill(c, cfg, torch.randn(1, n, Hkv, dh, generator=gen, device="cuda"),
                            torch.randn(1, n, Hkv, dh, generator=gen, device="cuda"))
        rows.append(c)
    cache = GQACache(*(torch.cat(ts).contiguous() for ts in zip(*rows)))
    q = torch.randn(B, Hkv * g, dh, generator=gen, device="cuda")
    pos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32, device="cuda")
    return q, cache, pos


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("Hkv,g,dh,window,N,block", [
    (8, 3, 128, 0, 192, 64),      # llama3.2-3b's heads
    (2, 8, 64, 0, 160, 64),       # qwen2.5-3b-like, N not a multiple of the block
    (4, 2, 32, 48, 96, 16),       # sliding window over a wrapped ring
    (1, 8, 16, 0, 128, 128),      # MQA
    (8, 1, 32, 0, 64, 16),        # MHA
    (2, 2, 128, 0, 1024, 512),    # block 512 at dh 128 (in bf16: no K/V stage fits)
    (2, 5, 64, 0, 65, 64),        # N one slot past a block edge
    (8, 6, 128, 0, 256, 128)])    # 144 blocks at width 1 (bf16: a ring shared by two per SM)
def test_gqa_decode_kernel_matches_plain(cuda, fmt, Hkv, g, dh, window, N, block):
    """#7 at every head-tile width: each width bitwise equal to every other,
    each within 1e-5 of the plain version (NaN rows, from a row with no
    token, equal), one launch counted per call."""
    from repro_torch.kernels.gqa_decode import kernel as GK
    from repro_torch.kernels.gqa_decode import ops as GO
    from repro_torch.core.kvcache import GQACache
    q, cache, pos = _gqa_case(fmt, 3, N, Hkv, g, dh, window, 16, [N + 40 if window else N,
                                                                 0, 37])
    if cache.k.shape[1] != N:  # the capacity, rounded up to the page, cut back to N
        cache = GQACache(*(t[:, :N].contiguous() if t.dim() > 1 else t for t in cache))
    kw = dict(window=window, block_n=block, fmt=fmt)
    want = GO.gqa_decode(q, cache, pos, use_kernel=False, **kw)
    outs = {}
    for w in GK.GQA_HEAD_WIDTHS:
        _lib.reset_launches()
        with GK.forced_gqa_head_width(w):
            outs[w] = GO.gqa_decode(q, cache, pos, **kw)
        assert _lib.LAUNCHES[GK.LAUNCH_KEY] == 1
        torch.testing.assert_close(outs[w], want, equal_nan=True, **TOL)
        assert torch.isnan(outs[w][1]).all() and torch.isfinite(outs[w][0]).all()
        assert torch.isfinite(outs[w][2]).all()
    first = outs[GK.GQA_HEAD_WIDTHS[0]]
    for w, got in outs.items():
        assert torch.equal(got.view(torch.int32), first.view(torch.int32)), w
    _lib.reset_launches()
    assert torch.equal(GO.gqa_decode(q, cache, pos, **kw).view(torch.int32),
                       first.view(torch.int32))
    assert _lib.LAUNCHES[GK.LAUNCH_KEY] == 1


def test_gqa_decode_rejections(cuda):
    from repro_torch.kernels.gqa_decode import kernel as GK
    q, cache, pos = _gqa_case("fp8_e4m3", 1, 64, 2, 2, 16, 0, 16, [10])
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale, cache.slot_pos, pos)
    with pytest.raises(ValueError, match="KV block"):
        GK.gqa_decode_cuda(q, *args, block_n=48)
    with pytest.raises(ValueError, match="dtype"):
        GK.gqa_decode_cuda(q, *args, fmt="int8")
    with pytest.raises(ValueError, match="dh"):
        GK.gqa_decode_cuda(q[..., :8].contiguous(), cache.k[..., :8].contiguous(),
                           cache.v[..., :8].contiguous(), *args[2:])


def _folded_case(fmt, page, H, d_c, d_r, P, q_len, seed):
    """A paged case over P pages (rows: empty, short, full, ragged) with a
    raw query (q_lat, q_rope) [B, (q_len,) H, .] float32 and the contiguous
    twin of its cache."""
    lens = [0, 37, P * page, P * page - page // 2 - 3]
    paged = _case(fmt, lens, P, page, q_len * H, d_c, d_r, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    B = len(lens)
    lead = (B, q_len, H) if q_len > 1 else (B, H)
    raw = (torch.randn(*lead, d_c, generator=g, device="cuda") * 3,
           torch.randn(*lead, d_r, generator=g, device="cuda"))
    raw[0].view(-1, d_c)[0] = 0.0          # the EPS floor of sigma_q
    return raw, paged, _contiguous(paged, P, page)


def _unfolded(raw, fmt):
    """D as its own launch: the prepared query of a raw one."""
    if fmt == "none":   # the "none" query is prepare_q's (no D)
        return R.prepare_q(*raw, fmt)
    q_lat, q_rope = raw
    lead, d_c = q_lat.shape[:-1], q_lat.shape[-1]
    flat = torch.cat([q_lat, q_rope], -1).reshape(lead[0], -1, d_c + q_rope.shape[-1])
    q8, qr, sq = QK.fused_q_quant_cuda(flat.contiguous(), d_c, fmt=fmt)
    return (q8.reshape(*lead, d_c), qr.reshape(*lead, -1), sq.reshape(lead))


FOLD_SHAPES = [(16, 4, 32, 16, 16), (64, 32, 512, 64, 16)]


@pytest.mark.parametrize("rescale", ["fma", "amla"])
@pytest.mark.parametrize("width", K.HEAD_WIDTHS)
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("page,H,d_c,d_r,P", FOLD_SHAPES)
def test_folded_launch_bitwise_equal_to_the_launches_it_replaces(cuda, rescale, width, fmt,
                                                                 page, H, d_c, d_r, P):
    """D in the prologue and C (FMA) or #4 (AMLA) in the epilogue: the one
    folded launch gives the bits of D, then the kernel, then C or #4 (D then
    B / #1 in single pass) — at widths 8 and 1, 1 to 16 splits (dead splits
    and rows with no token included: NaN / -inf with the same bits), paged
    and contiguous, the contiguous sink guard, and the verify mode at q_len
    4 and 5. fmt "none" folds the merge only (its query is prepare_q's)."""
    kw = dict(softmax_scale=0.1, fmt=fmt, rescale=rescale)
    # the exact design's folded bits (the sm90 design takes the fp8 FMA q_len 1
    # folded calls at d_c 512: tests/test_torch_sm90_cuda.py)
    with K.forced_head_width(width), K.forced_design("exact"):
        for q_len in (1, 4, 5):
            raw, paged, contig = _folded_case(fmt, page, H, d_c, d_r, P, q_len, seed=q_len)
            query = _unfolded(raw, fmt)
            fold_q = query if fmt == "none" else raw + (None,)
            sink = (torch.randn(len(paged[7]), 4, d_c, device="cuda") if q_len == 1
                    and fmt == "fp8_e4m3" else None)
            for S in (1, 2, 4, 8, 16):
                for name, fold, unfold in (
                        ("paged", lambda q: K.mla_decode_paged_splitkv_cuda(
                            *q, *paged[3:], num_splits=S, **kw),
                         lambda q: K.mla_decode_paged_splitkv_cuda(
                             *q, *paged[3:], num_splits=S, return_partials=True, **kw)),
                        ("contiguous", lambda q: K.mla_decode_splitkv_cuda(
                            *q, *contig[3:], num_splits=S, block_n=page, sink=sink, **kw),
                         lambda q: K.mla_decode_splitkv_cuda(
                             *q, *contig[3:], num_splits=S, block_n=page, sink=sink,
                             return_partials=True, **kw))):
                    _lib.reset_launches()
                    got = fold(fold_q)
                    assert sum(_lib.LAUNCHES.values()) == 1, (name, dict(_lib.LAUNCHES))
                    want = unfold(query)[:2]    # the kernel, then C on its partials
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                            (name, q_len, S)
            if q_len == 1 and fmt != "none":   # single pass: D + B / #1
                pairs = [(K.mla_decode_paged_cuda(*raw, None, *paged[3:], **kw),
                          K.mla_decode_paged_cuda(*query, *paged[3:], **kw)),
                         (K.mla_decode_cuda(*raw, None, *contig[3:], block_n=page,
                                            sink=sink, **kw),
                          K.mla_decode_cuda(*query, *contig[3:], block_n=page, sink=sink,
                                            **kw))]
                for got, want in pairs:
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_folded_tickets_return_to_zero_and_launches_repeat(cuda):
    """After folded launches (C under FMA, #4 under AMLA) every ticket
    counter reads 0 again, and two back-to-back folded launches give the
    same bits."""
    raw, paged, contig = _folded_case("fp8_e4m3", 16, 4, 32, 16, 16, 1, seed=9)
    for rescale in ("fma", "amla"):
        kw = dict(softmax_scale=0.1, num_splits=8, rescale=rescale)
        first = K.mla_decode_paged_splitkv_cuda(*raw, None, *paged[3:], **kw)
        second = K.mla_decode_paged_splitkv_cuda(*raw, None, *paged[3:], **kw)
        third = K.mla_decode_splitkv_cuda(*raw, None, *contig[3:], block_n=16, **kw)
        torch.cuda.synchronize()
        for a, b, c in zip(first, second, third):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        tickets = K._SCRATCH.tickets(torch.device("cuda", torch.cuda.current_device()), 1)
        assert tickets.numel() >= 4 * 4 and int(torch.count_nonzero(tickets)) == 0, rescale
