"""The plain reference against the port's plain backend at the smoke
configurations: the pool bytes, the FP8 decode pipeline, the MoE with its
capacity rule and a whole teacher-forced decode."""
import dataclasses

import pytest
import torch

import bench_smoke_cases as S
from harness import model, offline_decode
from plainref import mla_fp8

CPU = torch.device("cpu")


def test_store_matches_the_port_pool_write():
    from repro_torch.core import quant
    g = torch.Generator().manual_seed(0)
    c, k = torch.randn(5, 32, generator=g) * 3, torch.randn(5, 16, generator=g)
    q, r, s = mla_fp8.store_latents(c, k)
    raq = quant.quantize_rope_aware(c, k, "fp8_e4m3")
    assert torch.equal(q.float(), raq.q_content.float())
    assert torch.equal(r.float(), raq.rope_scaled.float())
    assert torch.equal(s, raq.scale[..., 0])


@pytest.mark.parametrize("n", [1, 16, 37, 96])
def test_attend_matches_the_pipeline(n):
    from repro_torch.core import quant
    from repro_torch.kernels.mla_decode import ref as KR
    g = torch.Generator().manual_seed(n)
    ql, qr = torch.randn(1, 4, 32, generator=g), torch.randn(1, 4, 16, generator=g)
    cq, cr, cs = mla_fp8.store_latents(torch.randn(1, 96, 32, generator=g),
                                       torch.randn(1, 96, 16, generator=g))
    raq = quant.quantize_rope_aware(ql, qr, "fp8_e4m3", rope_dtype=torch.float32)
    o, _ = KR.snapmla_decode_pipeline_ref(raq.q_content, raq.rope_scaled, raq.scale[..., 0],
                                          cq, cr, cs, torch.tensor([n]), softmax_scale=0.2,
                                          block_n=16)
    mine = mla_fp8.attend(ql[0], qr[0], cq[0], cr[0], cs[0], n, 0.2, 16)
    assert torch.allclose(mine, o[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tokens", [4, 11])
def test_moe_capacity_matches_the_port(tokens):
    from repro_torch.models import moe as M
    cfg = M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=1.0,
                      n_shared_experts=1)
    p = M.init_moe_params(torch.Generator().manual_seed(tokens), 16, cfg)
    x = torch.randn(tokens, 16, generator=torch.Generator().manual_seed(1))
    want, _ = M.moe_layer(p, cfg, x)
    got, (ids, keep) = mla_fp8.moe_mlp(p._asdict(), dataclasses.asdict(cfg), x,
                                    mla_fp8.Precision())
    assert not bool(keep.all())                  # the capacity rule dropped pairs
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("conf,name", [(S.MOE_CONF, "dsv3.decode_32k"),
                                       (S.DENSE_CONF, "mla7b.decode_32k")])
def test_decode_matches_the_port_plain_backend(conf, name):
    """One decode step of the port's plain pipeline backend against the
    reference over the same prompt latents."""
    from repro_torch.models import transformer as T
    wl = S.workload(name)
    cell = offline_decode.build(conf, wl, 3, CPU)
    cfg = dataclasses.replace(cell.cfg, decode_backend="torch_paged_pipeline",
                              use_kernels=False)
    logits, _ = T.decode_step(cell.params, cfg, cell.first, cell.state,
                              cell.ctx.to(torch.int32))
    ref, _ = mla_fp8.decode(cell.plain, dict(model.dims(conf), block=wl["page_size"]),
                            cell.latents, cell.ctx, cell.first[:, None], [0])
    assert torch.allclose(ref[0], logits, rtol=1e-4, atol=1e-5 * float(ref.std()))
