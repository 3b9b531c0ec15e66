"""The port's GQA decode against the JAX package's on the reference's grid in
the none format (see ``test_torch_gqa_decode.py``, which holds fp8_e4m3;
split by file so the three formats run in parallel)."""
import pytest

from test_torch_gqa_decode import GRID, check_grid_case


@pytest.mark.parametrize("Hkv,g,dh,window", GRID)
def test_none_grid_matches_jax(Hkv, g, dh, window):
    check_grid_case("none", Hkv, g, dh, window)
