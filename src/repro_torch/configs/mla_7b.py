"""mla-7b [mla-dense] — mid-size dense MLA model (DeepSeek-V2-Lite-like,
scaled), copied from ``repro/configs/mla_7b.py`` (the fields the port's
ModelConfig has)."""
import dataclasses

from repro_torch.configs.base import MLADims, ModelConfig

CONFIG = ModelConfig(
    name="mla-7b", family="mla",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=11008, vocab_size=102400,
    layer_pattern=("mla",), rope_theta=10000.0, act="silu",
    mla=MLADims(d_c=512, d_rope=64, q_lora_rank=0), max_seq_len=131072,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, mla=MLADims(d_c=32, d_rope=16),
        page_size=16, max_seq_len=128)
