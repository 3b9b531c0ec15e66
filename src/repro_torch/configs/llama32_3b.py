"""llama3.2-3b [dense]: 28L GQA (Hkv 8, g 3), copied from
``repro/configs/llama32_3b.py``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=128256,
    layer_pattern=("attn",), rope_theta=500000.0, act="silu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, page_size=16, max_seq_len=128)
