"""whisper-base [audio]: 6 encoder + 6 decoder layers, copied from
``repro/configs/whisper_base.py`` [arXiv:2212.04356]. The conv frontend is
a stub: the encoder reads precomputed frame embeddings [B, 1500, d]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, vocab_size=51865,
    layer_pattern=("dec",), act="gelu",
    encoder_layers=6, n_aux_tokens=1500,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, encoder_layers=2, n_aux_tokens=24,
        page_size=16, max_seq_len=128)
