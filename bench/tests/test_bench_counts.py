"""The frozen byte and operation counts against hand sums at a small shape."""
import pytest

import bench_smoke_cases as S  # noqa: F401
import _counts

D = dict(n_layers=2, d_model=8, n_heads=2, d_head=4, d_rope=2, d_c=6, q_lora_rank=0,
         vocab_size=10, tie=True, d_ff=12, moe=None)


def test_decode_bound_bytes_and_operations():
    lens = [3, 5]
    ms, which = _counts.decode_bound(lens, "fp8_e4m3", 1, 4, heads=2, d_c=6, d_r=2)
    nbytes = 8 * (6 + 4 + 4) + 2 * 2 * (6 + 8 + 4) + 2 * 5 * 4 + 2 * 2 * (24 + 4)
    flops = 8 * 2 * (2 * 8 + 12)
    assert which == "bytes"
    assert ms == pytest.approx(max(nbytes / 3.35e12, flops / 1979e12) * 1e3)


def test_dense_step_work_by_hand():
    lens = [3, 5]
    flops, attn, nbytes = _counts.step_work(D, "fp8_e4m3", lens)
    # MLA per token: W_UQ 8*2*6, W_DKV|W_KR 8*8, W_UK 6*2*4, W_UV 6*2*4, W_O 2*4*8
    mla_macs = 96 + 64 + 48 + 48 + 64
    mla_w = mla_macs + 6 + 2 * 8                 # + kv_norm + ln1, ln2
    mlp = 3 * 8 * 12
    assert flops == 2 * (2 * (2 * mla_macs + 2 * mlp) + 2 * 8 * 10)
    assert attn == 2 * 8 * 2 * (2 * (6 + 2) + 2 * 6)
    row = 6 + 2 * 2 + 4
    assert nbytes == 4 * (2 * (mla_w + mlp) + 80 + 8) + 2 * (8 + 2) * row + 2 * 10 * 4


def test_moe_step_reads_only_the_experts_kept():
    d = dict(D, moe=dict(n_experts=4, top_k=2, d_ff_expert=3, n_shared_experts=1))
    f1, _, b1 = _counts.step_work(d, "fp8_e4m3", [3, 5], experts_read=1, pairs_kept=2)
    f2, _, b2 = _counts.step_work(d, "fp8_e4m3", [3, 5], experts_read=3, pairs_kept=4)
    assert b2 - b1 == 2 * 4 * 2 * 3 * 8 * 3      # layers * 4 B * experts * 3 d f
    assert f2 - f1 == 2 * 2 * 2 * 3 * 8 * 3      # 2 FLOPs * layers * pairs * 3 d f


def test_least_time_takes_the_larger_bound():
    assert _counts.least_seconds(67e12, 0, 1.0, "fp8_e4m3") == pytest.approx(1.0)
    assert _counts.least_seconds(0, 0, 3.35e12, "fp8_e4m3") == pytest.approx(1.0)
    assert _counts.least_seconds(67e12, 1979e12, 0, "fp8_e4m3") == pytest.approx(2.0)


def test_untied_step_reads_the_output_table_too():
    tied = _counts.step_work(D, "fp8_e4m3", [3, 5])
    untied = _counts.step_work(dict(D, tie=False), "fp8_e4m3", [3, 5])
    assert untied[0] == tied[0] and untied[1] == tied[1]
    assert untied[2] - tied[2] == 4 * 10 * 8     # a second V x D float32 table
