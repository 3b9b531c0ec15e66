"""llama-3.2-vision-90b [vlm]: 100 layers, a tanh-gated cross-attention
layer every 5th, copied from ``repro/configs/llama32_vision_90b.py``. The
vision frontend is a stub: the cross layers read precomputed patch
embeddings (4 tiles x 1601 patches)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab_size=128256,
    layer_pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=500000.0, act="silu",
    n_aux_tokens=6404,                      # 4 tiles x 1601 patch embeddings
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_aux_tokens=24, page_size=16, max_seq_len=128)
