"""The fused decode loop on the card (``pytest -m cuda``; skipped without
one), on the smoke configs with the hand-written kernels:

  * every step's logits through the captured graph are bitwise equal to the
    same step run eagerly (``DecodeGraph.step``), and ``generate_fused``
    gives ``generate``'s tokens and logits bit for bit, with one decode
    kernel per layer and step (launched eagerly or recorded into the graph
    and replayed);
  * a decode-kernel scratch that no eager step has grown makes the capture
    raise;
  * sampling runs inside the graph: reproducible per seed, inside the top-k
    support, and equal to ``generate``'s draws with the same seed;
  * under ``torch.profiler`` a call records its six phases inside one
    ``snapmla.round`` as host ranges only (no device event of that name),
    records the same launches into the graph and returns the same bits.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fused_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

B, S, GEN = 3, 40, 8
RUNS = {  # id -> (arch, config fields, the decode kernel one step launches per layer)
    "mla_contiguous_kv0": ("mla-7b", dict(kv_splits=1), "single_pass_decode"),
    "mla_paged_kv0": ("mla-7b", dict(kv_paged=True, kv_splits=1), "paged_single_pass_decode"),
    "mla_paged_kv2": ("mla-7b", dict(kv_paged=True, kv_splits=2), "paged_splitkv_decode"),
    "mla_paged_kv2_amla": ("mla-7b", dict(kv_paged=True, kv_splits=2, kv_rescale="amla"),
                           "paged_splitkv_decode_amla"),
    "llama": ("llama3.2-3b", {}, "gqa_decode"),
    "deepseek_paged_kv0": ("deepseek-v3-mla", dict(kv_paged=True, kv_splits=1),
                           "paged_single_pass_decode"),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    _lib.lib()                       # build outside any capture
    return torch.device("cuda")


def model(run):
    arch, over, kernel = RUNS[run]
    cfg = dataclasses.replace(get_smoke_config(arch), decode_backend="kernel",
                              use_kernels=True, **over)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_model(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    return cfg, params, prompts, kernel


def prefilled(cfg, params, prompts):
    state = T.init_decode_state(cfg, B, S + GEN, device="cuda")
    logits, state = T.prefill(params, cfg, prompts, state)
    return logits.argmax(-1).to(torch.int32), state


@pytest.mark.parametrize("run", sorted(RUNS))
def test_captured_step_bitwise_equal_to_eager_step(cuda, run):
    cfg, params, prompts, _ = model(run)
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    eager = ST.DecodeGraph(cfg, params, *prefilled(cfg, params, prompts), pos)
    want = [eager.step().clone() for _ in range(GEN)]
    graph = ST.DecodeGraph(cfg, params, *prefilled(cfg, params, prompts), pos)
    got = [graph.step().clone()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph.capture(side)
    torch.cuda.current_stream().wait_stream(side)
    got += [graph.replay().clone() for _ in range(GEN - 1)]
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"step {i}: max diff {float((a - b).abs().max())}"
    assert torch.equal(graph.tok, eager.tok) and torch.equal(graph.pos, eager.pos)
    for a, b in zip(graph.state["layers"], eager.state["layers"]):
        assert torch.equal(a.seq_lens, b.seq_lens)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_generate_fused_equals_generate_and_counts_launches(cuda, run):
    cfg, params, prompts, kernel = model(run)
    toks, _, logits = serve.generate(cfg, params, prompts, GEN, return_logits=True)
    _lib.reset_launches()
    stats: dict = {}
    f_toks, tps, f_logits = serve.generate_fused(cfg, params, prompts, GEN,
                                                 return_logits=True, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(f_toks, toks)
    assert torch.equal(f_logits, logits), float((f_logits - logits).abs().max())
    assert stats["replays"] == GEN - 2 and tps > 0
    assert stats["graph_launches"] == dict(_lib.CAPTURED) == {kernel: cfg.n_layers}
    total = {k: _lib.LAUNCHES[k] + _lib.CAPTURED[k] * stats["replays"]
             for k in _lib.LAUNCHES | _lib.CAPTURED}
    assert total == {kernel: cfg.n_layers * (GEN - 1)}


def test_unwarmed_scratch_makes_capture_raise(cuda, monkeypatch):
    cfg, params, prompts, _ = model("mla_paged_kv2")
    monkeypatch.setattr(K, "_SCRATCH", K._Scratch())
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    loop = ST.DecodeGraph(cfg, params, *prefilled(cfg, params, prompts), pos)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="outside a CUDA-graph capture"):
        loop.capture(torch.cuda.Stream())


def test_sampling_runs_inside_the_graph(cuda):
    cfg, params, prompts, _ = model("mla_paged_kv2")
    kw = dict(temperature=0.8, top_k=8, seed=7)
    a, _, logits = serve.generate_fused(cfg, params, prompts, GEN, return_logits=True, **kw)
    b, _ = serve.generate_fused(cfg, params, prompts, GEN, **kw)
    c, _ = serve.generate(cfg, params, prompts, GEN, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    top = torch.topk(logits, 8, dim=-1).indices                    # [B, GEN, 8]
    assert (top == a[..., None].long()).any(-1).all()


PHASES = ["snapmla.round.buffers", "snapmla.round.eager", "snapmla.round.capture",
          "snapmla.round.first_sync", "snapmla.round.replays", "snapmla.round.release"]


@pytest.mark.parametrize("run", ["mla_paged_kv2", "deepseek_paged_kv0"])
def test_profiled_round_records_host_spans_only_and_changes_nothing(cuda, run):
    cfg, params, prompts, kernel = model(run)
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    fused = ST.make_fused_decode(cfg, GEN, return_logits=True)
    plain_stats: dict = {}
    want = fused(params, *prefilled(cfg, params, prompts), pos, stats=plain_stats)
    tok, state = prefilled(cfg, params, prompts)
    stats: dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = fused(params, tok, state, pos, stats=stats)
    events = list(prof.profiler.kineto_results.events())
    on_device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_device, "the profiler recorded no device activity"
    assert not [e.name() for e in on_device if e.name().startswith("snapmla.")]
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name().startswith("snapmla.")), key=lambda x: (x[1], -x[2]))
    assert [x[0] for x in spans] == ["snapmla.round"] + PHASES
    _, a, b = spans[0]
    assert all(a <= x[1] and x[2] <= b for x in spans[1:])
    assert all(x[2] <= y[1] for x, y in zip(spans[1:], spans[2:]))
    assert stats["graph_launches"] == plain_stats["graph_launches"] == {kernel: cfg.n_layers}
    assert stats["replays"] == GEN - 1 and stats["release_s"] > 0
    assert stats["capture_s"] >= stats["eager_s"] > 0
    (ta, sa, oka, la), (tb, sb, okb, lb) = want, got
    assert torch.equal(ta, tb) and torch.equal(la, lb) and bool(oka) and bool(okb)
    for x, y in zip(sa["layers"], sb["layers"]):
        for u, v in zip(x, y):
            assert torch.equal(u.view(torch.uint8), v.view(torch.uint8)) \
                if u.dtype == torch.float8_e4m3fn else torch.equal(u, v)
