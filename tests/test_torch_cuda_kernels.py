"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (phase 2 of chip_smoke.py at small sizes). Needs an NVIDIA GPU
and nvcc; skipped elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.core.kvcache import CacheConfig, PagedMLAPool, mla_quantize_entry
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.kernels.mla_decode import ref as R
from repro_torch.kernels.quantize import kernel as QK
from repro_torch.kernels.quantize import ref as QR

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


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
