"""The control at a CPU size: the plain reference one precision lower (its
float32 matrix products at TF32) in the program's place reads far above the
program on the numbers compared, and at the cell's depth the cell's own
limits judge it not correct. (The cells' limits are set from the same
readings on the card, at the cells' own sizes.)"""
import json

import pytest
import torch

import bench_smoke_cases as S
from bench_smoke_cases import one_thread  # noqa: F401  (autouse)
from harness import check, offline_decode
from plainref import mla_fp8

CPU = torch.device("cpu")
CELLS = [(S.MOE_CONF, "dsv3.decode_32k", "deepseek-v3-mla"),
         (S.DENSE_CONF, "mla7b.decode_32k", "mla-7b")]


def _run(conf, name):
    return offline_decode.run(conf, S.workload(name), 2**31 + 3, 0.0, False, CPU,
                              t_start=0.0, readers={}, control=True)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 3 * 2**-11), 2**-20])
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, -(1.0 + 2**-9), 2**-20])
    assert torch.equal(mla_fp8.tf32(x), want)


@pytest.mark.parametrize("conf,name", [c[:2] for c in CELLS])
def test_control_reads_far_above_the_program(conf, name):
    out = _run(conf, name)
    assert out.correct, out.compared
    prog, low = out.readings["logit_dev_mean"], out.control["logit_dev_mean"]
    assert low > 1e-3 and low > 100 * prog, (prog, low)


@pytest.mark.parametrize("conf,name,config", CELLS)
def test_control_is_not_correct_under_the_cells_limits(conf, name, config):
    """The smoke widths at the configuration's own depth: the control's
    deviation grows with the layers it passes through, as the cells' limits
    assume (mla-7b: 30 layers)."""
    depth = json.loads((S.BENCH / "configs" / f"{config}.json").read_text())
    out = _run(dict(conf, num_hidden_layers=depth["num_hidden_layers"]), name)
    assert out.correct, out.compared
    control_correct, compared = check.judge(out.control, S.workload(name)["check"]["limits"])
    assert not control_correct, compared
