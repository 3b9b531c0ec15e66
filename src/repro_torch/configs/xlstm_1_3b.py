"""xlstm-1.3b [ssm]: 48 layers, mLSTM and sLSTM at 7:1, d_ff 0 (the blocks
are self-contained), copied from ``repro/configs/xlstm_1_3b.py``
[arXiv:2405.04517]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab_size=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    act="gelu",
    subquadratic=True,
    max_seq_len=524288,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
        vocab_size=256, page_size=16, max_seq_len=128)
