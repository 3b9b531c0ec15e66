"""The decode kernels' head-tile rule (``kernels/mla_decode/kernel.py::
head_width``): how many heads each CUDA block computes, picked per launch
from the grid it gives. Pure Python, so it runs on the CPU; that every width
gives the same bits is checked on the card (tests/test_torch_cuda_kernels.py).
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K

H100_SMS = 132


def _ctas(batch, rows, splits, width):
    return batch * -(-rows // width) * splits


GRID = list(itertools.product((1, 2, 4, 8, 32), (1, 4, 8, 32, 128, 160, 640), (1, 2, 4, 8)))


@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_head_width_returns_an_instantiated_width(sms):
    assert sorted(K.HEAD_WIDTHS, reverse=True) == list(K.HEAD_WIDTHS)
    assert len(set(K.HEAD_WIDTHS)) == len(K.HEAD_WIDTHS) == 2
    for batch, rows, splits in GRID:
        assert K.head_width(batch, rows, splits, sms) in K.HEAD_WIDTHS


@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_head_width_covers_the_sms_where_a_width_can(sms):
    """The pick covers the SMs whenever some width does, and is the widest
    that does (fewest L2 re-reads); when none does, it is the narrowest."""
    for batch, rows, splits in GRID:
        w = K.head_width(batch, rows, splits, sms)
        covering = [x for x in K.HEAD_WIDTHS if _ctas(batch, rows, splits, x) >= sms]
        if covering:
            assert w == max(covering)
            assert _ctas(batch, rows, splits, w) >= sms
        else:
            assert w == min(K.HEAD_WIDTHS)


@pytest.mark.parametrize("batch,heads,q_len,splits", [
    (4, 32, 1, 1),      # mla-7b decode, single pass: 16 blocks at width 8
    (4, 32, 1, 4),      # ... at 4 splits: 64
    (4, 32, 5, 1),      # E3's verify: R = 160 rows, 80 blocks at width 8
    (4, 32, 5, 8),      # ... at 8 splits: 640
    (4, 128, 1, 1),     # deepseek-v3-mla's 128 heads: 64 blocks at width 8
    (32, 128, 1, 1),    # a large batch: 512 blocks at width 8
])
def test_head_width_at_serving_shapes(batch, heads, q_len, splits):
    """Width 8 exactly where its grid covers the H100's 132 SMs, counting
    the verify mode's q_len * heads rows."""
    rows = q_len * heads
    wide = _ctas(batch, rows, splits, 8) >= H100_SMS
    assert K.head_width(batch, rows, splits, H100_SMS) == (8 if wide else min(K.HEAD_WIDTHS))


@pytest.mark.parametrize("q_len,splits", [(1, 1), (1, 4), (5, 1), (4, 8)])
def test_wrapper_passes_the_rule_s_width_for_the_flattened_rows(monkeypatch, q_len, splits):
    """The split wrapper flattens a [B, q_len, H, .] query to R = q_len * H
    rows and launches with head_width(B, R, splits, SMs): the launch's
    arguments are captured in place of a launch."""
    B, H, d_c, d_r, page, P = 2, 8, 32, 16, 16, 8
    rng = np.random.default_rng(q_len * 10 + splits)
    shape_q = (B, q_len, H) if q_len > 1 else (B, H)
    q_c8 = torch.from_numpy(rng.standard_normal(shape_q + (d_c,)).astype(np.float32)).to(
        torch.float8_e4m3fn)
    q_r = torch.from_numpy(rng.standard_normal(shape_q + (d_r,)).astype(np.float32))
    sigma_q = torch.ones(shape_q)
    n_pool = B * P
    content = torch.zeros(n_pool, page, d_c, dtype=torch.float8_e4m3fn)
    rope = torch.zeros(n_pool, page, d_r, dtype=torch.bfloat16)
    scale = torch.ones(n_pool, page)
    table = torch.arange(n_pool, dtype=torch.int32).reshape(B, P)
    lens = torch.tensor([P * page, 20], dtype=torch.int32)
    seen = {}

    class Launched(Exception):
        pass

    def launch(kernel, fn_name, *args):
        seen.update(kernel=kernel, H=args[22], width=args[-1], q_len=args[-2])
        raise Launched

    monkeypatch.setattr(K, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(_lib, "sm_count", lambda index: 12)
    monkeypatch.setattr(_lib, "launch", launch)
    with pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(q_c8, q_r, sigma_q, content, rope, scale, table, lens,
                                        softmax_scale=0.1, num_splits=splits)
    rows = q_len * H
    assert seen["H"] == rows and seen["q_len"] == q_len
    assert seen["width"] == K.head_width(B, rows, splits, 12)
    assert seen["kernel"] == "paged_splitkv_decode" + ("_verify" if q_len > 1 else "")
    with K.forced_head_width(K.HEAD_WIDTHS[0]), pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(q_c8, q_r, sigma_q, content, rope, scale, table, lens,
                                        softmax_scale=0.1, num_splits=splits)
    assert seen["width"] == K.HEAD_WIDTHS[0]


def test_forced_head_width_rejects_a_width_not_instantiated():
    with pytest.raises(ValueError, match="head width"):
        with K.forced_head_width(3):
            pass
