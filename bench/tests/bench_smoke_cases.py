"""Small configurations and traffic for the benchmark's CPU tests: the
smoke widths of the port's deepseek-v3-mla and mla-7b, and cells of a few
short rows."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src", BENCH / "metrics"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

MOE_CONF = {
    "hidden_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "q_lora_rank": 48, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 16, "v_head_dim": 16, "vocab_size": 256, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": True, "n_routed_experts": 4,
    "num_experts_per_tok": 2, "moe_intermediate_size": 32, "n_shared_experts": 1,
    "norm_topk_prob": True, "intermediate_size": 128,
    "port": {"arch": "deepseek-v3-mla", "capacity_factor": 1.5},
}
DENSE_CONF = {
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 16, "v_head_dim": 16, "vocab_size": 256, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": True, "intermediate_size": 128,
    "port": {"arch": "mla-7b"},
}


def workload(name: str, **over) -> dict:
    """A cell's traffic file, cut to a CPU size (rows, contexts, rounds)."""
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    wl = copy.deepcopy(wl)
    small = {"batch": 4, "context": {"kind": "uniform", "lo": 40, "hi": 90},
             "round_tokens": 6, "max_rounds": 2, "page_size": 16, "latent_block": 32}
    small.update(over)
    wl.update(small)
    wl["check"] = dict(wl["check"], per_round=3, rounds=2, rows=2)
    return wl


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
