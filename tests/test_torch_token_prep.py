"""The token-preparation kernels' launch plan and their port at the layer
API's full widths.

``kernels/quantize/kernel.py::token_prep_plan`` picks, per launch of D
(``csrc/q_quant.cu``) or #9 (``csrc/k_append.cu``), the instantiation (the
MLA widths compiled in, or runtime widths) and gives the grid; it is pure
Python, so it runs here. That every instantiation gives the plain version's
bytes is checked on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py). Then the port's D and #9 (their plain versions, on CPU
tensors) against the JAX Pallas kernels in interpret mode at d_c 512, d_r 64
(mla-7b's and deepseek-v3-mla's widths), 32 and 128 heads, fp8 and int8:
bytes equal.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.kernel import fused_k_append_pallas, fused_q_quant_pallas
from repro_torch.kernels import _lib
from repro_torch.kernels.quantize import kernel as QK

D_C, D_R = 512, 64


def test_constants_match_the_sources():
    """FULL_WIDTHS are common.cuh's kTokenDc / kTokenDr, Q_ROWS_PER_BLOCK
    q_quant.cu's kQuantRows; the MLA configs have those widths."""
    from repro_torch.configs import get_config
    common = (_lib.CSRC / "common.cuh").read_text()
    widths = dict(re.findall(r"constexpr int (kTokenDc|kTokenDr) = (\d+);", common))
    assert (int(widths["kTokenDc"]), int(widths["kTokenDr"])) == QK.FULL_WIDTHS
    rows = re.search(r"#define SNAPMLA_Q_ROWS (\d+)\n#endif\nconstexpr int kQuantRows = "
                     r"SNAPMLA_Q_ROWS;", (_lib.CSRC / "q_quant.cu").read_text())
    assert int(rows[1]) == QK.Q_ROWS_PER_BLOCK
    for arch in ("mla-7b", "deepseek-v3-mla"):
        cfg = get_config(arch)
        assert (cfg.mla.d_c, cfg.mla.d_rope) == QK.FULL_WIDTHS


# (kernel, rows, d_c, d_r, aligned) -> (full, blocks)
PLANS = [
    (("q_quant", 4 * 32, 512, 64, True), (True, 32)),        # mla-7b, batch 4
    (("q_quant", 4 * 128, 512, 64, True), (True, 128)),      # deepseek, batch 4
    (("q_quant", 64 * 128, 512, 64, True), (True, 2048)),    # deepseek, batch 64
    (("q_quant", 4 * 132 + 3, 512, 64, True), (True, 133)),  # a ragged last block
    (("q_quant", 4 * 32, 512, 64, False), (False, 32)),      # a view not aligned
    (("q_quant", 27, 96, 32, True), (False, 7)),             # runtime widths
    (("q_quant", 10, 512, 32, True), (False, 3)),
    (("q_quant", 600, 32, 16, False), (False, 150)),
    (("k_append", 4, 512, 64, True), (True, 4)),
    (("k_append", 64, 512, 64, True), (True, 64)),
    (("k_append", 64, 512, 64, False), (False, 64)),
    (("k_append", 3, 96, 32, True), (False, 3)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_plan_picks_the_instantiation_and_the_grid(args, want):
    assert QK.token_prep_plan(*args) == want


@pytest.mark.parametrize("rows", [1, 5, 27, 128, 131, 132, 133, 263, 264, 512, 1055, 1056,
                                  1057, 8192])
def test_every_row_has_one_warp_and_no_block_is_empty(rows):
    """Block x, warp w of D's grid takes row x * Q_ROWS_PER_BLOCK + w when it
    is below the row count (q_quant.cu): every row is taken once and every
    block takes one at least."""
    width = QK.Q_ROWS_PER_BLOCK
    _, blocks = QK.token_prep_plan("q_quant", rows, 96, 32, True)
    taken = [x * width + w for x in range(blocks) for w in range(width) if x * width + w < rows]
    assert sorted(taken) == list(range(rows))
    assert all(x * width < rows for x in range(blocks))


def test_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no kernel"):
        QK.token_prep_plan("fetch", 4, 512, 64, True)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.int8):
            return x.view(torch.uint8).numpy()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if a.dtype.name in ("float8_e4m3fn", "int8"):
        return a.view(np.uint8)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B,H", [(4, 32), (2, 128)])
def test_fused_q_quant_at_full_width_bit_exact_vs_pallas(fmt, B, H):
    rs = np.random.RandomState(B * 1000 + H)
    q = (rs.standard_normal((B, H, D_C + D_R)) * 4).astype(np.float32)
    q[0, 0, :D_C] = 0.0                                  # the EPS floor
    q[-1, -1, :4] = [448.0, -0.5, 2.5, 1e-3]
    want = fused_q_quant_pallas(jnp.asarray(q), D_C, fmt=fmt)
    got = QK.fused_q_quant_cuda(torch.from_numpy(q), D_C, fmt=fmt)
    for t, j in zip(got, want):
        assert t.shape == tuple(np.asarray(j).shape)
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B", [4, 16])
def test_fused_k_append_at_full_width_bit_exact_vs_pallas(fmt, B):
    """The same cache, one entry per row written at ragged positions (the
    first row at 0, one at the last row), an EPS-floor entry; every byte of
    content, rope and scale equal, the rest of the cache untouched."""
    N, page = 256, 128
    rs = np.random.RandomState(B)
    qdt = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8}[fmt]
    content = torch.from_numpy(rs.randint(-100, 100, (B, N, D_C)).astype(np.int8))
    content = content.view(torch.uint8).view(qdt) if fmt == "fp8_e4m3" else content
    rope = torch.from_numpy((rs.standard_normal((B, N, D_R))).astype(np.float32)).bfloat16()
    scale = torch.from_numpy(rs.rand(B, N).astype(np.float32))
    c = (rs.standard_normal((B, D_C)) * 3).astype(np.float32)
    r = (rs.standard_normal((B, D_R)) * 10).astype(np.float32)
    c[1] = 0.0
    lens = rs.randint(0, N, B).astype(np.int32)
    lens[0], lens[-1] = 0, N - 1
    before = [t.clone() for t in (content, rope, scale)]
    as_jax = [jnp.asarray(_bits(content).view(jnp.float8_e4m3fn if fmt == "fp8_e4m3"
                                              else np.int8)),
              jnp.asarray(rope.float().numpy()).astype(jnp.bfloat16), jnp.asarray(scale.numpy())]
    want = fused_k_append_pallas(*as_jax, jnp.asarray(c), jnp.asarray(r), jnp.asarray(lens),
                                 page=page, fmt=fmt)
    got = QK.fused_k_append_cuda(content, rope, scale, torch.from_numpy(c), torch.from_numpy(r),
                                 torch.from_numpy(lens), fmt=fmt)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(_bits(t), _bits(j))
    changed = (got[2] != before[2]) | (got[1] != before[1]).any(-1)
    changed |= torch.from_numpy((_bits(got[0]) != _bits(before[0])).any(-1))
    assert sorted(torch.nonzero(changed).tolist()) == [[b, int(n)] for b, n in enumerate(lens)]
