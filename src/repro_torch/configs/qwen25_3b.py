"""qwen2.5-3b [dense]: 36L GQA (Hkv 2, g 8) with QKV bias, copied from
``repro/configs/qwen25_3b.py``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
    d_ff=11008, vocab_size=151936,
    layer_pattern=("attn",), qkv_bias=True, rope_theta=1000000.0, act="silu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, page_size=16, max_seq_len=128)
