"""The GQA decode kernel's head-tile rule (``kernels/gqa_decode/kernel.py::
gqa_head_width``): how many query heads of one kv head each CUDA block of #7
computes, picked per launch from the grid it gives. Pure Python, so it runs
on the CPU; that every width gives the same bits is checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 8).
"""
import itertools
import re

import pytest

from repro_torch.kernels import _lib
from repro_torch.kernels.gqa_decode import kernel as GK

H100_SMS = 132


def _ctas(batch, kv_heads, g, width):
    return batch * kv_heads * -(-g // width)


GRID = list(itertools.product((1, 2, 4, 8, 32, 64), (1, 2, 4, 8, 16), (1, 2, 3, 4, 7, 8)))


def test_gqa_head_widths_match_the_instantiations():
    """Two widths, widest first, width 1 among them, and the same two that
    gqa_decode.cu instantiates (kGqaWide, kGqaNarrow)."""
    assert sorted(GK.GQA_HEAD_WIDTHS, reverse=True) == list(GK.GQA_HEAD_WIDTHS)
    assert len(set(GK.GQA_HEAD_WIDTHS)) == len(GK.GQA_HEAD_WIDTHS) == 2
    assert 1 in GK.GQA_HEAD_WIDTHS
    src = (_lib.CSRC / "gqa_decode.cu").read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"constexpr int (kGqaWide|kGqaNarrow) = (\d+);", src)}
    assert (consts["kGqaWide"], consts["kGqaNarrow"]) == GK.GQA_HEAD_WIDTHS


@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_gqa_head_width_returns_an_instantiated_width(sms):
    for batch, kv_heads, g in GRID:
        assert GK.gqa_head_width(batch, kv_heads, g, sms) in GK.GQA_HEAD_WIDTHS


@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_gqa_head_width_covers_the_sms_where_a_width_can(sms):
    """The pick covers the SMs whenever some width does, and is then the
    widest that does (fewest re-reads of each K/V block); when none does, it
    is the narrowest (the most CUDA blocks)."""
    for batch, kv_heads, g in GRID:
        w = GK.gqa_head_width(batch, kv_heads, g, sms)
        covering = [x for x in GK.GQA_HEAD_WIDTHS if _ctas(batch, kv_heads, g, x) >= sms]
        if covering:
            assert w == max(covering)
            assert _ctas(batch, kv_heads, g, w) >= sms
        else:
            assert w == min(GK.GQA_HEAD_WIDTHS)


@pytest.mark.parametrize("batch,kv_heads,g,ctas", [
    (4, 8, 3, 96),      # llama3.2-3b at its serving batch
    (4, 2, 8, 64),      # qwen2.5-3b
    (2, 16, 2, 64),     # gemma3-27b's window layers
])
def test_gqa_head_width_at_serving_shapes(batch, kv_heads, g, ctas):
    """Width 1 at the GQA family's serving shapes on an H100: no width's grid
    covers the 132 SMs there, and width 1 gives the most blocks."""
    assert GK.gqa_head_width(batch, kv_heads, g, H100_SMS) == 1
    assert _ctas(batch, kv_heads, g, 1) == ctas


def test_forced_gqa_head_width_overrides_and_restores():
    assert GK._TILES.forced is None
    for w in GK.GQA_HEAD_WIDTHS:
        with GK.forced_gqa_head_width(w):
            assert GK._TILES.forced == w
            with GK.forced_gqa_head_width(GK.GQA_HEAD_WIDTHS[-1]):
                assert GK._TILES.forced == GK.GQA_HEAD_WIDTHS[-1]
            assert GK._TILES.forced == w
        assert GK._TILES.forced is None


def test_forced_gqa_head_width_rejects_a_width_not_instantiated():
    with pytest.raises(ValueError, match="GQA head width"):
        with GK.forced_gqa_head_width(3):
            pass
    assert GK._TILES.forced is None
