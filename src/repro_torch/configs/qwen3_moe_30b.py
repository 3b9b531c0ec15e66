"""qwen3-moe-30b-a3b [moe]: 48L, 128 experts top-8 (d_ff_expert=768), copied
from ``repro/configs/qwen3_moe_30b.py``. [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab_size=151936,
    layer_pattern=("attn",), rope_theta=1000000.0, act="silu",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.25),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=1.5),
        page_size=16, max_seq_len=128)
