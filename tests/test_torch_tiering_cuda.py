"""The host tier's stream order on the card (``pytest -m cuda``; skipped
without one), at mla-7b's page (128 tokens, d_c 512, d_r 64) over 30 layers,
so each copy moves the 2.47 MB a real page offload moves:

  * an offload followed at once by a prefill into the freed page (the page
    id is back on the free list) leaves the host copy equal to the page
    before the write: the compute stream waits for the offload's event;
  * a prefetch followed at once by the restore's write leaves the page
    byte-identical to the offloaded one: the write waits for the upload's
    event, and the pinned source outlives the copy.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tiering_cuda.py
"""
import pytest
import torch

from repro_torch.core import kvcache as tkv
from repro_torch.serving.tiering import HostTier

pytestmark = pytest.mark.cuda

LAYERS, PAGES, PAGE, D_C, D_R = 30, 8, 128, 512, 64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _pools(dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = tkv.CacheConfig(page_size=PAGE)
    pools = []
    for _ in range(LAYERS):
        p = tkv.init_paged_mla_pool(cfg, PAGES, 2, 1, D_C, D_R, device=dev)
        p.content.copy_(torch.randn(p.content.shape, generator=g, device=dev))
        p.rope.copy_(torch.randn(p.rope.shape, generator=g, device=dev))
        p.scale.copy_(torch.rand(p.scale.shape, generator=g, device=dev))
        pools.append(p._replace(page_table=torch.tensor([[3, 3]], dtype=torch.int32,
                                                        device=dev)))
    return cfg, pools


def _bytes(leaves):
    return [t.contiguous().view(torch.uint8).cpu() for leaf in leaves for t in leaf]


def test_offload_then_prefill_into_freed_page(cuda):
    cfg, pools = _pools(cuda)
    tier = HostTier(2, device=cuda)
    before = _bytes([tuple(t.clone() for t in tkv.pool_read_page(p, 3)) for p in pools])
    slot = tier.alloc_slot()
    tier.store(slot, [tkv.pool_read_page(p, 3) for p in pools])
    # at once, on the compute stream: a chunk prefill writes the whole page
    g = torch.Generator(device=cuda).manual_seed(1)
    start = torch.zeros((1,), dtype=torch.int32, device=cuda)
    valid = torch.ones((1, PAGE), dtype=torch.bool, device=cuda)
    for p in pools:
        tkv.paged_mla_prefill_at(p, cfg, torch.randn(1, PAGE, D_C, generator=g, device=cuda),
                                 torch.randn(1, PAGE, D_R, generator=g, device=cuda),
                                 start, valid)
    torch.cuda.synchronize()
    tier.synchronize()
    host = tier._data[slot]
    assert all(t.is_pinned() for leaf in host for t in leaf)
    assert all(torch.equal(a, b) for a, b in zip(_bytes(host), before))
    after = _bytes([tkv.pool_read_page(p, 3) for p in pools])
    assert not torch.equal(after[0], before[0])           # the prefill did land


def test_prefetch_then_write_restores_the_page(cuda):
    _, pools = _pools(cuda, seed=2)
    tier = HostTier(2, device=cuda)
    before = _bytes([tuple(t.clone() for t in tkv.pool_read_page(p, 3)) for p in pools])
    slot = tier.alloc_slot()
    tier.store(slot, [tkv.pool_read_page(p, 3) for p in pools])
    for p in pools:                                       # page 3 is reused
        p.content.view(torch.uint8)[3].zero_()
    tier.prefetch(slot)
    for p, leaf in zip(pools, tier.take(slot)):           # restore into page 5 at once
        tkv.pool_write_page(p, 5, leaf)
    torch.cuda.synchronize()
    got = _bytes([tkv.pool_read_page(p, 5) for p in pools])
    assert all(torch.equal(a, b) for a, b in zip(got, before))
    assert tier.restores == 1 and tier.prefetches == 1 and tier.num_used == 0
