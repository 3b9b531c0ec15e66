"""mixtral-8x7b [moe]: 32L, 8 experts top-2, sliding-window attention,
copied from ``repro/configs/mixtral_8x7b.py``. [arXiv:2401.04088; hf]"""
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=0, vocab_size=32000,
    layer_pattern=("swa",), window=4096, rope_theta=1000000.0, act="silu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, capacity_factor=1.25),
    subquadratic=True,  # SWA bounds every layer's cache
    max_seq_len=524288,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        vocab_size=256, window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.5),
        page_size=16, max_seq_len=128)
