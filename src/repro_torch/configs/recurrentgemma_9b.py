"""recurrentgemma-9b [hybrid]: 38 layers, RG-LRU and local attention at 2:1
(window 2048), MQA at d_head 256, copied from
``repro/configs/recurrentgemma_9b.py`` [arXiv:2402.19427].

38 = 12 (rglru, rglru, swa) superblocks + 2 remainder rglru layers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab_size=256000,
    layer_pattern=("rglru", "rglru", "swa"), window=2048,
    rope_theta=10000.0, act="gelu",
    subquadratic=True,
    max_seq_len=524288,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab_size=256, window=16, page_size=16, max_seq_len=128)
