"""The fused fetch-dequant kernel's launch geometry
(``kernels/quantize/fetch_dequant.py::fetch_geometry``): how many tokens each
warp of K1 (``csrc/fetch_dequant.cu``) copies and the grid of token slices
that gives, picked per launch so that the grid covers the SMs. Pure Python,
so it runs on the CPU; that every tokens-per-warp gives the plain version's
bytes is checked on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""
import itertools
import re

import pytest

from repro_torch.kernels import _lib
from repro_torch.kernels.quantize import fetch_dequant as FD

H100_SMS = 132
SRC = (_lib.CSRC / "fetch_dequant.cu").read_text()


def _covered(B, P, page, tpw, grid):
    """Every (row, page, token) the launch's warps copy, by the kernel's own
    indexing: warp w of block (x, j, b) takes the tokens from
    t0 = (x * kFetchWarps + w) * tpw, cut at the page's end."""
    gx, gy, gz = grid
    assert (gy, gz) == (P, B)
    out = []
    for x, j, b, w in itertools.product(range(gx), range(P), range(B), range(FD.FETCH_WARPS)):
        t0 = (x * FD.FETCH_WARPS + w) * tpw
        out += [(b, j, t) for t in range(t0, min(t0 + tpw, page))]
    return out


def test_constants_match_the_kernel():
    """FETCH_WARPS and the largest tokens per warp are the .cu's kFetchWarps
    and kMaxTokensPerWarp; the widths run most first down to 1; the kernel
    indexes its tokens as ``_covered`` does."""
    consts = {name: int(val) for name, val in re.findall(
        r"constexpr int (kFetchWarps|kMaxTokensPerWarp) = (\d+);", SRC)}
    assert consts == {"kFetchWarps": FD.FETCH_WARPS,
                      "kMaxTokensPerWarp": max(FD.TOKENS_PER_WARP)}
    assert list(FD.TOKENS_PER_WARP) == sorted(FD.TOKENS_PER_WARP, reverse=True)
    assert FD.TOKENS_PER_WARP[-1] == 1
    assert "const int t0 = (blockIdx.x * kFetchWarps + warp) * tpw;" in SRC
    assert "if (t0 >= page) return;" in SRC and "const int n = min(tpw, page - t0);" in SRC


@pytest.mark.parametrize("page", [16, 32, 64, 128, 256, 512, 6, 10, 100])
def test_every_token_is_copied_exactly_once(page):
    """At every tokens per warp the kernel takes, pages of 16 to 512 tokens
    and pages that are not a multiple of any slice."""
    B, P = 2, 3
    for tpw in FD.TOKENS_PER_WARP:
        with FD.forced_tokens_per_warp(tpw):
            got_tpw, grid = FD.fetch_geometry(B, P, page, H100_SMS)
        assert got_tpw == tpw
        units = _covered(B, P, page, tpw, grid)
        assert len(units) == len(set(units)) == B * P * page
        assert set(units) == set(itertools.product(range(B), range(P), range(page)))
        # no block of the grid is empty
        assert (grid[0] - 1) * FD.FETCH_WARPS * tpw < page


def test_engine_shape_fills_the_sms():
    """E2's chunk step (B = 1, 8 pages of 128 tokens) runs at least one
    block per SM of an H100 (8 blocks before the token slices), and 32k
    tokens per row (B = 4, 256 pages) take the most tokens per warp."""
    tpw, grid = FD.fetch_geometry(1, 8, 128, H100_SMS)
    assert grid[0] * grid[1] * grid[2] >= H100_SMS
    assert (tpw, grid) == (1, (32, 8, 1))
    assert FD.fetch_geometry(4, 256, 128, H100_SMS) == (4, (8, 256, 4))


@pytest.mark.parametrize("sms", [H100_SMS, 16, 1])
def test_pick_is_the_most_tokens_per_warp_that_covers_the_sms(sms):
    """The most tokens per warp (the more loads in flight per lane) whose grid
    covers the SMs; where none does, 1 (the most blocks)."""
    for B, P, page in itertools.product((1, 2, 4), (1, 3, 8, 64, 256), (16, 128, 512)):
        tpw, grid = FD.fetch_geometry(B, P, page, sms)
        blocks = {w: -(-page // (FD.FETCH_WARPS * w)) * P * B for w in FD.TOKENS_PER_WARP}
        covering = [w for w in FD.TOKENS_PER_WARP if blocks[w] >= sms]
        assert tpw == (max(covering) if covering else 1)
        assert grid[0] * grid[1] * grid[2] == blocks[tpw]


def test_forced_tokens_per_warp_overrides_and_restores():
    assert FD.fetch_geometry(1, 8, 128, H100_SMS)[0] == 1
    with FD.forced_tokens_per_warp(4):
        assert FD.fetch_geometry(1, 8, 128, H100_SMS) == (4, (8, 8, 1))
    assert FD.fetch_geometry(1, 8, 128, H100_SMS)[0] == 1
    with pytest.raises(ValueError, match="tokens per warp"):
        with FD.forced_tokens_per_warp(3):
            pass
