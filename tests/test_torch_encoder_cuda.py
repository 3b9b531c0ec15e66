"""The encoder families' kernel path and the training step on the card
(``pytest -m cuda``; skipped without one):

  * #7, the FP8 GQA decode kernel, over the static cross caches of
    whisper-base (MHA: Hkv 8, g 1, d_head 64; 1,500 frames in 1,536 slots)
    and llama-3.2-vision-90b (Hkv 8, g 8, d_head 128; 6,404 patches in
    6,528 slots), batch 4, the query at ``transformer.CROSS_POS`` past
    every slot: within rtol / atol 1e-5 of its plain version in fp8, int8
    and bf16, both head-tile widths bitwise equal, one launch per call;
  * one smoke train step of whisper-base (encoder, aux embeddings) on the
    card within 1e-5 of the same step on the CPU (parameters, AdamW
    moments, metrics), from the same weights, batch and optimizer state
    (after one CPU step, so the moments are not zero).

The first call builds the kernels (``build/``).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encoder_cuda.py
"""
import pytest
import torch

from repro_torch.core.kvcache import CacheConfig, GQACache, gqa_prefill, init_gqa_cache
from repro_torch.kernels import _lib

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cross_case(fmt, n_aux, Hkv, g, dh, batch=4, seed=0):
    from repro_torch.models.transformer import CROSS_POS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = CacheConfig(fmt=fmt, page_size=128)
    cache = init_gqa_cache(cfg, batch, n_aux, Hkv, dh, device="cuda")
    cache = gqa_prefill(cache, cfg,
                        torch.randn(batch, n_aux, Hkv, dh, generator=gen, device="cuda"),
                        torch.randn(batch, n_aux, Hkv, dh, generator=gen, device="cuda"))
    q = torch.randn(batch, Hkv * g, dh, generator=gen, device="cuda")
    pos = torch.full((batch,), CROSS_POS, dtype=torch.int32, device="cuda")
    return q, cache, pos


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("n_aux,Hkv,g,dh,capacity", [
    (1500, 8, 1, 64, 1536),            # whisper-base
    (6404, 8, 8, 128, 6528)],          # llama-3.2-vision-90b
    ids=["whisper", "vision"])
def test_cross_cache_matches_plain_at_both_widths(cuda, fmt, n_aux, Hkv, g, dh, capacity):
    from repro_torch.kernels.gqa_decode import kernel as GK
    from repro_torch.kernels.gqa_decode import ops as GO
    q, cache, pos = _cross_case(fmt, n_aux, Hkv, g, dh)
    assert cache.capacity == capacity and isinstance(cache, GQACache)
    kw = dict(window=0, block_n=128, fmt=fmt)
    want = GO.gqa_decode(q, cache, pos, use_kernel=False, **kw)
    outs = {}
    for w in GK.GQA_HEAD_WIDTHS:
        _lib.reset_launches()
        with GK.forced_gqa_head_width(w):
            outs[w] = GO.gqa_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES == {"gqa_decode": 1}
    first = outs[GK.GQA_HEAD_WIDTHS[0]]
    for o in outs.values():
        assert torch.equal(o.view(torch.int32), first.view(torch.int32))
    assert torch.isfinite(first).all()
    torch.testing.assert_close(first, want, **TOL)


def test_smoke_train_step_matches_cpu(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import init_adamw, tree_leaves, tree_map
    cfg = get_smoke_config("whisper-base")
    params = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1,
                      n_aux_tokens=cfg.n_aux_tokens, d_model=cfg.d_model)
    step = make_train_step(cfg, warmup_steps=2, total_steps=10)
    params, opt, _ = step(params, init_adamw(params), synth_batch(data, 0), 0)
    batch = synth_batch(data, 3)
    c_params, c_opt, c_metrics = step(params, opt, batch, 3)

    def to_card(t):
        return t.to("cuda")
    g_params, g_opt, g_metrics = step(tree_map(to_card, params), tree_map(to_card, opt),
                                      {k: v.cuda() for k, v in batch.items()}, 3)
    for got, want in ((g_params, c_params), (g_opt, c_opt)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a.cpu(), b, **TOL)
    for k, v in c_metrics.items():
        torch.testing.assert_close(torch.as_tensor(g_metrics[k]).cpu().float(),
                                   torch.as_tensor(v).float(), **TOL)
