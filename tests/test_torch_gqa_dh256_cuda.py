"""#7, the FP8 GQA decode kernel, at d_head 256 (recurrentgemma-9b's MQA:
Hkv 1, g 16) on the card (``pytest -m cuda``; skipped without one): against
its plain version (``gqa_decode_plain``) within rtol / atol 1e-5 in fp8,
int8 and bf16, at both head-tile widths (bitwise equal to each other), one
launch per call; the serving shape (a 640-slot ring under a 2,048 window),
a wrapped 2,048-slot ring (window 2048) and a KV block of 64. The first
call builds the kernels (``build/``).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gqa_dh256_cuda.py
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


def _case(fmt, N, window, page, lens, g=16, dh=256, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = CacheConfig(fmt=fmt, page_size=page, window=window)
    rows = []
    for n in lens:
        c = init_gqa_cache(cfg, 1, N, 1, dh, device="cuda")
        if n:
            c = gqa_prefill(c, cfg, torch.randn(1, n, 1, dh, generator=gen, device="cuda"),
                            torch.randn(1, n, 1, dh, generator=gen, device="cuda"))
        rows.append(c)
    cache = GQACache(*(torch.cat(ts).contiguous() for ts in zip(*rows)))
    q = torch.randn(len(lens), g, dh, generator=gen, device="cuda")
    pos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32, device="cuda")
    return q, cache, pos


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("N,window,page,lens", [
    (640, 2048, 128, [527, 512, 520, 513]),       # the serving shape
    (2048, 2048, 128, [3000, 2100, 0, 2048]),     # a wrapped ring, an empty row
    (256, 0, 64, [256, 37, 200])])                # block 64, no window
def test_dh256_matches_plain_at_both_widths(cuda, fmt, N, window, page, lens):
    from repro_torch.kernels.gqa_decode import kernel as GK
    from repro_torch.kernels.gqa_decode import ops as GO
    q, cache, pos = _case(fmt, N, window, page, lens)
    kw = dict(window=window, block_n=page, fmt=fmt)
    want = GO.gqa_decode(q, cache, pos, use_kernel=False, **kw)
    outs = {}
    for w in GK.GQA_HEAD_WIDTHS:
        _lib.reset_launches()
        with GK.forced_gqa_head_width(w):
            outs[w] = GO.gqa_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES == {GK.LAUNCH_KEY: 1}
        torch.testing.assert_close(outs[w], want, equal_nan=True, **TOL)
    first = outs[GK.GQA_HEAD_WIDTHS[0]]
    for w, got in outs.items():
        assert torch.equal(got.view(torch.int32), first.view(torch.int32)), w
    empty = [b for b, n in enumerate(lens) if n == 0]
    live = [b for b, n in enumerate(lens) if n]
    assert torch.isnan(first[empty]).all() and torch.isfinite(first[live]).all()


def test_dh256_model_layer_launches_the_kernel(cuda):
    """A recurrentgemma-9b ``swa`` layer at full width decodes through #7
    (one launch) and agrees with the plain backend's parallel form within
    the serve gate's 1e-2 of the largest output."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    base = get_config("recurrentgemma-9b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = L.init_attn_params(gen, T._attn_cfg(base, "swa"), device="cuda")
    x = torch.randn(4, base.d_model, generator=gen, device="cuda")
    pos = torch.full((4,), 600, dtype=torch.int32, device="cuda")
    outs = {}
    for backend in ("kernel", "ref"):
        cfg = dataclasses.replace(base, decode_backend=backend, use_kernels=backend == "kernel")
        cache = T._init_layer_state(cfg, "swa", 4, 640, "cuda")
        cache = cache._replace(seq_lens=torch.full((4,), 600, dtype=torch.int32, device="cuda"))
        cache.slot_pos[:, :600] = torch.arange(600, dtype=torch.int32, device="cuda")
        _lib.reset_launches()
        outs[backend], _ = T._attn_decode(p, cfg, "swa", x, cache, pos)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES == ({"gqa_decode": 1} if backend == "kernel" else {})
    rel = float((outs["kernel"] - outs["ref"]).abs().max() / outs["ref"].abs().max())
    assert rel < 1e-2, rel
