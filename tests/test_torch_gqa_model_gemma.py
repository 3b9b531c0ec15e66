"""gemma3-27b's smoke config (8 layers: one 5:1 swa:attn superblock and a
2-layer swa tail, window 16, GELU) through the port against the JAX package,
as ``test_torch_gqa_model.py`` holds llama3.2-3b and qwen2.5-3b. Prompts of
20 tokens overflow the 16-slot rings, so prefill keeps the last 16 tokens
and every decode step wraps."""
import pytest

from repro_torch.launch import serve as tserve
from test_torch_gqa_model import check_forward, check_generate, check_teacher_forced

ARCH = "gemma3-27b"


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
def test_gemma_generate_matches_jax(fmt):
    check_generate(ARCH, fmt, B=2, S=20)


def test_gemma_forward_matches_jax():
    check_forward(ARCH, S=40)


def test_gemma_teacher_forced_decode_reproduces_forward():
    check_teacher_forced(ARCH, S=20)


def test_serve_main_cpu_gemma(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "kernel",
                 "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "gemma3-27b" in out and "generated (2, 4)" in out
