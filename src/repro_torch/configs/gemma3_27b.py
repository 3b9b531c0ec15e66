"""gemma3-27b [dense]: 62L, 5:1 local:global (window 1024), GELU, copied
from ``repro/configs/gemma3_27b.py``.

62 = 10 full (5 swa + 1 attn) superblocks + 2 remainder swa layers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab_size=262144,
    layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    window=1024, rope_theta=1000000.0, act="gelu",
    subquadratic=True,  # dominantly local; global layers are linear per decode step
    max_seq_len=524288,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, window=16, page_size=16, max_seq_len=128)
