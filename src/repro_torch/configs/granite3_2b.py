"""granite-3-2b [dense]: 40L GQA (Hkv 8, g 4, d_head 64), copied from
``repro/configs/granite3_2b.py``. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab_size=49155,
    layer_pattern=("attn",), rope_theta=10000.0, act="silu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, page_size=16, max_seq_len=128)
