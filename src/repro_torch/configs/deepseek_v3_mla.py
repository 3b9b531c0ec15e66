"""deepseek-v3-mla [mla-moe] — the paper's primary evaluation family, copied
from ``repro/configs/deepseek_v3_mla.py``.

DeepSeek-V3-style: 61L MLA (d_c=512, d_rope=64, q_lora=1536), MoE with 256
routed experts top-8 + 1 shared expert; every layer MoE, as in the
reference. [arXiv:2412.19437]
"""
import dataclasses

from repro_torch.configs.base import MLADims, ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-mla", family="mla",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=0, vocab_size=129280,
    layer_pattern=("mla",), rope_theta=10000.0, act="silu",
    mla=MLADims(d_c=512, d_rope=64, q_lora_rank=1536),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25, n_shared_experts=1),
    max_seq_len=131072,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        vocab_size=256, mla=MLADims(d_c=32, d_rope=16, q_lora_rank=48),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                      capacity_factor=1.5, n_shared_experts=1),
        page_size=16, max_seq_len=128)
