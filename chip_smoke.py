#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):

  1. build   — compile the hand-written kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel) and print the card's name and
               power limit as nvidia-smi gives them;
  2. kernels — every kernel of the serving paths against its plain PyTorch
               version on the card, on one random cache held both contiguous
               ([B, N, .]) and as a shuffled page pool: the serving shape
               (mla-7b, batch 4, 512-527 tokens, 5 blocks of 128), a ragged
               ~32k-token case, a sink-guarded cache (S_k = 4), int8 and none
               at a smaller shape; FMA and AMLA at 1/4/8 splits; contiguous
               against paged bit for bit at block_n == page; Fused-Q-Quant and
               Fused-K-Append bytes. Kernel median ms, plain ms and bound ms.
               Every decode call is repeated folded — a raw query quantized in
               the kernel's prologue (D), and the split partials merged in its
               epilogue (C under FMA, #4 under AMLA) — bitwise against D, the
               kernel, then C or #4, at every head-tile width, and timed
               beside the launches it replaces (the "folded D / C / #4"
               line). The MLA cases are repeated at deepseek-v3-mla's 128
               heads (``serve_shape_h128``, ``long_32k_h128`` and their q_len
               5 / 4 verify cases, with a head-tile width line). D and #9
               are held bitwise at each of their instantiations (the MLA
               widths, runtime widths, views not 16-byte aligned; EPS floor,
               clamp past capacity),
               fp8 and int8; D is timed at batch 64 x 128 heads with its L2
               cold (``deepseek_b64``), #9 at batch 64 (``b64``), beside a
               ``launch_floor`` line (an in-place add on one element) and
               their ptxas line (a spill fails);
  3. layer   — ``core.snapmla.decode_step``, one full-width layer over a
               ~32k-token cache, paged and contiguous (Fused-K-Append), drawn
               from its own generator: kernels vs the reference backend
               (``LAYER_LIMIT``; a bfloat16-input control reported), cache
               bytes vs the plain append;
  4. serve   — ``launch.serve.generate`` on full mla-7b (30 layers, float32
               weights from a seeded generator), batch 4, prompt 512, gen 16,
               contiguous and paged caches, FMA and AMLA, kv_splits 0 and 4, a
               sink-guarded run: kernel backend against the plain backend (the
               kernels' plain version, ``torch_pipeline`` /
               ``torch_paged_pipeline``, FMA or AMLA), and contiguous against
               paged greedy tokens; each run one decode
               launch per layer and step (C and #4 folded); then
               ``launch.serve.generate_fused`` (one decode step captured once
               as a CUDA graph and replayed per token) on paged kv0, paged kv4
               FMA and AMLA and contiguous kv0: the step loop's tokens, every
               step's logits bitwise equal to the step loop's, the plain
               backend's gates, and one decode launch per layer and step
               (eager plus captured times replays);
  4b. shard-map — ``launch.serve.generate`` on the same full mla-7b with
               ``decode_backend="shard-map"``: each MLA layer's attention and
               cache append run in the collective-free ``local_map`` region
               over a (1, 1) ("data", "model") mesh, NCCL at world size 1
               started in this process by ``launch.mesh.make_host_mesh``;
               contiguous cache, kv_splits 0 and 4: tokens and every step's
               logits bitwise equal to ``decode_backend="ref"``
               (``torch_ref``), every resolve ``shard_map``, no kernel
               launch, 0 collectives over one decode step under
               ``CommDebugMode``; at kv_splits 0 also ``generate_fused``
               (the region inside the captured step), bitwise equal to the
               step loop; tok/s, and host wall per decode step against
               device ms (torch.profiler), for both backends. The world
               ends with the phase;
  5. engine  — ``repro_torch.serving.ServingEngine`` on full mla-7b, kernel
               backend, over the shared paged pool: E1 monolithic admission
               with staggered arrivals and a shared prefix through
               ``serve.run_engine`` (its exact greedy oracle gate); E2 chunked
               prefill (the fused fetch-dequant kernel) against the same engine
               on the plain backend, with the oracle's agreement reported; E3
               speculative decoding (the q_len > 1 split-KV kernel) against the
               non-speculative engine and the plain backend, and its AMLA mode
               against the non-speculative AMLA engine and the plain AMLA
               backend. Then the engine's state off the card: E4 (three
               requests sharing a 2-page prefix, arrivals 24 steps apart, chunk
               128, a prefix cache of 1 page and a host tier of 8) against the
               same run cold (tokens equal, at least one offload and one host
               restore), with the tier's offload / upload microseconds per page
               beside the page's bytes over the pinned copy rates measured in
               the call; E4 restartable (through ``serve.run_restartable``,
               preempted two steps after the first offload: the snapshot
               carries the populated tier) and E5 (E1
               through ``run_engine`` with ``--restartable --ckpt-every 4
               --inject preempt:6 --trace-out --quant-health-every 4``: E1's
               tokens, the trace validated with one track per request, the
               probe's resident pages and finite scale range), each with one
               preemption and one restore, the snapshot's bytes and seconds.
               Every run: fault counters 0, no leaked page;
  6. counts  — the launch counters, set to 0 just before and read just after
               each main path (phase 3's kernel steps, phase 4's and phase 5's
               kernel and fused runs; a launch recorded into a CUDA graph
               counts once per replay): every kernel of the paths launched at
               least once
               (C and #4 run folded there, so only phase 2 launches them
               alone; D alone only in phase 3's layer API);
  7. profile — one decode step of the serving run under torch.profiler (paged
               at kv_splits 0 and 4, FMA, and at 4 under AMLA; contiguous at
               0), run eagerly (the step loop) and as the captured graph's
               replay (the fused loop, ``fused``) on one state, one
               chunked-prefill step and one verify step: host wall, device
               kernel time, the device's idle share, top kernels, and the
               capture's seconds;
  8. gqa     — the dense GQA family, after mla-7b's weights are freed: the FP8
               GQA decode kernel (#7) against its plain version at llama3.2-3b's
               serving shape (fp8, int8, none), qwen2.5-3b's heads, gemma3-27b's
               wrapped 1,024-slot ring, MQA, MHA and a ragged ~32k-token case,
               each at every head-tile width (bitwise equal to each other), one
               line with each width's ms beside the rule's pick (adding two
               batches past the SMs, checked the same way), and one with
               the registers and spills of every #7 instantiation (a spill
               fails);
               ``launch.serve.generate`` on full llama3.2-3b (28 layers, batch
               4, prompt 512, gen 16, fp8 and none) and on gemma3-27b at full
               width cut to one 6-layer superblock (batch 2, prompt 1,200 past
               its 1,024-token window, gen 16, fp8), kernel backend against the
               reference backend, #7's launches exactly one per layer and decode
               step; llama3.2-3b fp8 also through ``generate_fused`` (the gates
               of phase 4); one llama decode step under torch.profiler, eager
               and replayed. #7 is also
               held at granite-3-2b's d_head 64 (serving shape and ~32k), and
               ``serve.generate`` runs on full granite-3-2b (40 layers) and
               on one full-width layer of mixtral-8x7b and of
               qwen3-moe-30b-a3b (MoE MLPs), #7 once per layer and step.
               The recurrent families: #7 at recurrentgemma-9b's d_head 256
               (MQA, Hkv 1, g 16; fp8, int8, none at the serving shape, a
               wrapped 2,048-slot ring under its 2,048 window, and ~32k), then
               ``serve.generate`` on full recurrentgemma-9b (38 layers: 26
               rglru, 12 swa through #7, once per swa layer and step) and
               full xlstm-1.3b (48 mlstm / slstm layers, no kernel on its
               path), each also through ``generate_fused`` (the gates of
               phase 4) and profiled, eager and replayed. #7 is also held at
               the encoder families' static cross caches (whisper-base: Hkv
               8, g 1, d_head 64, 1,500 frames in 1,536 slots; vision: Hkv 8,
               g 8, d_head 128, 6,404 patches in 6,528; batch 4, the query
               past every slot; fp8, int8, none), and its bf16 cases at
               llama's serving shape, 32k, d_head 256 and both cross shapes
               are timed beside ``scaled_dot_product_attention`` on the same
               K / V (the kernel row's ``library_ms``);
  8b. encoder — ``serve.generate`` and ``generate_fused`` on whisper-base at
               full width and depth (6 encoder, 6 'dec' layers) and
               llama-3.2-vision-90b at published widths cut to 5 of 100
               layers (4 'attn', 1 'cross'), batch 4, prompt 512, gen 16,
               random aux embeddings, every cross gate 0.5: the gates of
               phase 8, the fused loop bitwise equal to the step loop, #7
               12 and 5 times per decode step (a 'dec' layer: self, then
               cross), one step profiled;
  8c. train  — ``launch.train.train_loop`` through its mesh (an NCCL world
               of one, (1, 1)) on mla-7b (4 of 30 layers, batch 8, seq 512)
               and whisper-base (full, batch 8, seq 448, its aux
               embeddings), 20 steps each: finite, falling loss; ms per
               step, tokens/s, peak memory, model FLOP/s against the f32
               peak; on mla-7b, step 1's loss and grad_norm bitwise equal to
               ``make_train_step`` on plain tensors from the same seed and
               steps 2-3 within rel 1e-6, and the meshed step and the plain
               one timed in turns; a preempt-and-resume round on
               whisper-base;
  8d. dry run — ``launch.dryrun.run_cell`` (mla-7b x decode_32k x pod, 2
               layers) in a subprocess on the host: a fake 256-rank world
               over meta tensors, its record on its own line;
  9. deepseek — deepseek-v3-mla at full width (128 heads, q-LoRA, 256
               experts top-8 + 1 shared) cut to one layer, after every other
               model is freed: ``serve.generate`` contiguous kv0, paged kv0,
               paged kv4 FMA and AMLA (the gates of phase 4), ``generate_fused``
               on paged and contiguous kv0, both loops again at batch 64,
               prompt 128 (two rows per expert in the decode MoE calls), held
               to the plain backend, the engine with
               chunked prefill and speculative decoding held to the plain
               backend forced onto its tokens (its agreement with
               ``generate`` reported: MoE capacity drops differ between the
               engine's and ``generate``'s batches, in the reference too), K1
               and K2 once per layer and step, and its decode step under
               torch.profiler, eager and replayed, beside the expert weights'
               byte bound.

After phase 2 the split autotuner sweeps the paged decode kernels once at
mla-7b's serving shape (``autotune.measure_split_sweep``, CUDA-graph
replays) into ``build/chip_smoke_splits_profile.json`` (never the committed
``H100_splits_profile.json``), and the resolution rule, fed that file,
returns the sweep's best. The serve and engine gates expect the decode
kernel their split plan resolves to (the committed profile's plan, else the
heuristic).

Phase 2 also holds the fused fetch-dequant kernel (#11 paged, #10 its
contiguous mode) bitwise against its plain version at ~32k tokens and at the
engine's shape, at every tokens per warp it takes (each one's ms beside the
pick of ``fetch_geometry``), and the q_len > 1 verify mode of the split-KV
kernels (#6, #2) at a verify shape and at ~32k: against the plain version,
each row bitwise against the q_len = 1 kernel at its limit, and the q_len = 1
launches bitwise against a build without the verify code
(``-DSNAPMLA_NO_VERIFY``), whose q_len = 1 register counts must match. Every
decode launch of phase 2 is also repeated at each head-tile width the kernel
is instantiated for (heads per CUDA block), bitwise equal to width 8, and one
line gives each width's ms for B, A and K2 at the serving shape and at ~32k
beside the width the wrappers pick.

The line before the last holds the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, without
a card or without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK = {"fp8_e4m3": 1979e12, "int8": 1979e12, "none": 989e12, "f32": 67e12}
PAGE, H, D_C, D_R = 128, 32, 512, 64
DS_HEADS = 128                       # deepseek-v3-mla's query heads
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's AMLA kernel-vs-oracle gate (tests/test_parity.py:148-163)
AMLA_O, AMLA_LSE = dict(rtol=0.0, atol=1e-4), dict(rtol=0.0, atol=1e-5)

SRC_DECODE = "src/repro_torch/csrc/mla_decode.cu"
SRC_SM90 = "src/repro_torch/csrc/mla_decode_sm90.cu"
SRC_QQUANT = "src/repro_torch/csrc/q_quant.cu"
SRC_KAPPEND = "src/repro_torch/csrc/k_append.cu"
SRC_FETCH = "src/repro_torch/csrc/fetch_dequant.cu"
SRC_GQA = "src/repro_torch/csrc/gqa_decode.cu"
TPU_GQA = "src/repro/kernels/gqa_decode/kernel.py"
TPU_DECODE = "src/repro/kernels/mla_decode/kernel.py"
TPU_QUANT = "src/repro/kernels/quantize/kernel.py"
TPU_FETCH = "src/repro/kernels/quantize/fetch_dequant.py"
KERNELS = {  # launch-counter name -> (source, the TPU kernel it replaces, mode)
    "paged_splitkv_decode": (SRC_DECODE, f"{TPU_DECODE}:794", "fma"),
    # A's sm90 design: the fp8 FMA q_len = 1 split calls at the MLA widths
    "paged_splitkv_decode_sm90": (SRC_SM90, f"{TPU_DECODE}:794", "fma"),
    "paged_single_pass_decode": (SRC_DECODE, f"{TPU_DECODE}:694", "fma"),
    "lse_combine": (SRC_DECODE, f"{TPU_DECODE}:614", "fma"),
    "fused_q_quant": (SRC_QQUANT, f"{TPU_QUANT}:50", None),
    "splitkv_decode": (SRC_DECODE, f"{TPU_DECODE}:516", "fma"),
    "single_pass_decode": (SRC_DECODE, f"{TPU_DECODE}:268", "fma"),
    "amla_combine": (SRC_DECODE, f"{TPU_DECODE}:665", "amla"),
    "fused_k_append": (SRC_KAPPEND, f"{TPU_QUANT}:112", None),
    # the AMLA mode of each decode kernel: the rescale == "amla" branch of
    # _block_pipeline (kernel.py:152) inside the same entry point
    "paged_splitkv_decode_amla": (SRC_DECODE, f"{TPU_DECODE}:794", "amla"),
    "paged_single_pass_decode_amla": (SRC_DECODE, f"{TPU_DECODE}:694", "amla"),
    "splitkv_decode_amla": (SRC_DECODE, f"{TPU_DECODE}:516", "amla"),
    "single_pass_decode_amla": (SRC_DECODE, f"{TPU_DECODE}:268", "amla"),
    # the fused fetch-dequant kernel: paged (#11), and its contiguous mode (#10)
    "paged_fetch_dequant": (SRC_FETCH, f"{TPU_FETCH}:95", None),
    "fetch_dequant": (SRC_FETCH, f"{TPU_FETCH}:67", None),
    # the q_len > 1 verify mode of the split-KV kernels (kernel.py:381-399)
    "paged_splitkv_decode_verify": (SRC_DECODE, f"{TPU_DECODE}:794", "fma"),
    "paged_splitkv_decode_verify_amla": (SRC_DECODE, f"{TPU_DECODE}:794", "amla"),
    "splitkv_decode_verify": (SRC_DECODE, f"{TPU_DECODE}:516", "fma"),
    "splitkv_decode_verify_amla": (SRC_DECODE, f"{TPU_DECODE}:516", "amla"),
    # the FP8 GQA decode (#7), on the dense GQA family's decode path
    "gqa_decode": (SRC_GQA, f"{TPU_GQA}:107", None),
}
# kernels no model path calls (the reference's callers are not on a model
# path either): held against their plain versions in phase 2 only
OFF_PATH = {"fetch_dequant": "its caller chunked_prefill_attention has no model path",
            "paged_splitkv_decode": "the sm90 design takes every fp8 FMA q_len = 1 split "
                                    "call of the model paths; the exact A runs int8 / none "
                                    "pools, returned partials and calls pinned to it",
            "lse_combine": "folded into the FMA split kernels' epilogue on every model path; "
                           "a launch only where a caller keeps the partials",
            "amla_combine": "folded into the AMLA split kernels' epilogue on every model path; "
                            "a launch only where a caller keeps the partials",
            "splitkv_decode_verify": "the verify step runs on the paged pool only",
            "splitkv_decode_verify_amla": "the verify step runs on the paged pool only"}
# the kernels whose work the decode kernels also do in the same launch
FOLDED_INTO = {"fused_q_quant": f"the prologue of every MLA decode kernel ({SRC_DECODE})",
               "lse_combine": f"the epilogue of the FMA split kernels ({SRC_DECODE})",
               "amla_combine": f"the epilogue of the AMLA split kernels ({SRC_DECODE})"}
# the split count each kernel's summary row reports: serving shape, long case
SUMMARY_SPLITS = {"split": (4, 8), "single": (1, 1), "other": (1, 1)}
# the (case, splits) of each summary row: main shape, long case
SUMMARY_CASES = {
    "paged_fetch_dequant": (("engine_shape", 0), ("long_32k", 0)),
    "fetch_dequant": (("engine_shape", 0), ("long_32k", 0)),
    **{k: (("verify_shape", 1), ("long_32k_verify", 8)) for k in KERNELS if "verify" in k},
    "gqa_decode": (("gqa_llama_serve", 0), ("gqa_long_32k", 0)),
    # A's sm90 design at the two cells' shapes (filled in by sm90_checks)
}
# the cases of each row's extra measurements in the summary line: (main
# shape, splits), (long case, splits) for a kernel name and its kind's splits
SUMMARY_EXTRA = {
    "h128": lambda name, s, ls: (("serve_shape_h128_verify", 1),
                                 ("long_32k_h128_verify", 8)) if "verify" in name
    else (("serve_shape_h128", s), ("long_32k_h128", ls)),
    "dh64": lambda name, s, ls: (("gqa_granite_serve", 0), ("gqa_granite_long_32k", 0)),
    "dh256": lambda name, s, ls: (("gqa_rg_serve", 0), ("gqa_rg_long_32k", 0)),
    # the encoder families' static cross caches: whisper-base, then vision
    "cross": lambda name, s, ls: (("gqa_cross_whisper", 0), ("gqa_cross_vision", 0)),
}
# D's and #9's batch-64 case in the summary line (deepseek_b64: L2 cold)
B64_CASE = {"fused_q_quant": "deepseek_b64", "fused_k_append": "b64"}
# E1-E3 (phase 5): serve's engine flags
E1 = ["--batch", "6", "--max-batch", "3", "--prompt-lens", "640,200,384",
      "--shared-prefix", "256", "--gen", "16", "--arrival-gap", "2"]
E2 = ["--batch", "4", "--max-batch", "2", "--prompt-lens", "1000,130,513,256",
      "--prefill-chunk", "256", "--prefill-budget", "512", "--gen", "16"]
E3 = ["--batch", "4", "--max-batch", "4", "--prompt-len", "512", "--gen", "24",
      "--spec-draft", "4"]
# E4 (phase 5b): tests/test_prefix_cache.py:307-329's workload at mla-7b's page
# of 128: a 2-page shared prefix + 64 tokens of each request's own, arrivals
# past each request's lifetime, so reuse comes from retained pages; the
# prefix cache keeps 1 page and the host tier takes the other
E4 = ["--batch", "3", "--max-batch", "2", "--prompt-len", "320", "--shared-prefix", "256",
      "--gen", "6", "--arrival-gap", "24", "--prefill-chunk", "128"]
E4_TIER = ["--prefix-cache-pages", "1", "--host-tier-pages", "8"]
# E5 (phase 5b): E1 restartable, traced and probed (--ckpt-dir, --trace-out added)
E5_STATE = ["--restartable", "--ckpt-every", "4", "--inject", "preempt:6",
            "--quant-health-every", "4"]
NO_VERIFY = ("SNAPMLA_NO_VERIFY",)


def _kind(name: str) -> str:
    if "single_pass" in name:
        return "single"
    if "splitkv" in name or "combine" in name:
        return "split"
    return "other"


def emit(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


def check_close(name, got, want, *, rtol, atol, equal_nan=False) -> float:
    """|got - want| <= atol + rtol*|want| elementwise (NaNs must coincide when
    ``equal_nan``); returns the max abs error over the finite entries."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=rtol, atol=atol, equal_nan=equal_nan):
        diff = (got - want).abs()
        raise AssertionError(f"{name}: max abs err {float(diff.nan_to_num(float('inf')).max())}"
                             f" beyond rtol={rtol} atol={atol}")
    fin = torch.isfinite(want) & torch.isfinite(got)
    return float((got - want).abs()[fin].max()) if bool(fin.any()) else 0.0


def check_bitwise(name, got, want) -> None:
    """Raw bytes equal (NaNs included)."""
    import torch
    a, b = got.contiguous(), want.contiguous()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
            a.view(torch.uint8), b.view(torch.uint8)):
        raise AssertionError(f"{name}: not bit-identical")


def width_gate(name, call) -> None:
    """The decode launches inside ``call`` at every instantiated head-tile
    width give width 8's bits (outputs and partials)."""
    from repro_torch.kernels.mla_decode import kernel as K

    def flat(x):
        return [t for y in x for t in flat(y)] if isinstance(x, (tuple, list)) else [x]
    with K.forced_head_width(8):
        want = flat(call())
    for w in K.HEAD_WIDTHS[1:]:
        with K.forced_head_width(w):
            got = flat(call())
        for a, b in zip(got, want, strict=True):
            check_bitwise(f"{name} width {w} vs width 8", a, b)


FOLDS: list = []   # the folded launches' checks and times (phase 2)


def fold_gate(lbl, folded, unfolded) -> None:
    """The folded launch (D in the prologue, C or #4 in the split epilogue)
    at every instantiated head-tile width gives the bits of the launches it
    replaces (``unfolded``: D, then the kernel, then C or #4), in one
    launch."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    want = unfolded()
    for w in K.HEAD_WIDTHS:
        with K.forced_head_width(w):
            _lib.reset_launches()
            got = folded()
            n = sum(_lib.LAUNCHES.values())
        if n != 1:
            raise AssertionError(f"{lbl}: the folded call made {dict(_lib.LAUNCHES)} launches, "
                                 "not 1")
        for a, b in zip(got, want, strict=True):
            check_bitwise(f"{lbl} folded at width {w} vs unfolded", a, b)


def fold_time(entry, folded, kernel, replaced, **parts) -> None:
    """Device ms of the folded launch, of the unfolded decode kernel alone
    and of the launches the folded one replaces (D, the kernel, C or #4),
    each replayed back to back (kernel_ms), into ``entry``; ``parts`` (name
    -> call): the kernel with one of the two folds only."""
    entry.update(folded_ms=kernel_ms(folded), kernel_ms=kernel_ms(kernel),
                 replaced_ms=kernel_ms(replaced),
                 **{f"{k}_ms": kernel_ms(fn) for k, fn in parts.items()})
    entry["fold_cost_ms"] = entry["folded_ms"] - entry["kernel_ms"]
    entry["no_slower"] = entry["folded_ms"] <= entry["replaced_ms"]


def time_ms(fn, reps: int = 3) -> float:
    """Median host-to-device ms of one call of ``fn`` (CUDA events around each
    call, after a warm-up call). For the plain versions: many small ops, whose
    launch cost is part of what they take."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def kernel_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Device ms of one call of a kernel wrapper: ``inner`` calls captured in a
    CUDA graph and replayed between CUDA events, so the Python wrapper's own
    cost is not counted; median over ``reps`` replays. The inputs stay in L2
    where they fit (50 MB), as they do in back-to-back decode calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def decode_bound(lens, fmt, splits, table_entries, heads=H, d_c=D_C, d_r=D_R):
    """Least time for one decode call: bytes the call must move (the live
    tokens' content, rope and scale, the query, the page-table entries (0 for
    a contiguous cache), the outputs) over HBM bandwidth vs its QK + PV
    operations at the format's tensor-core peak."""
    B = len(lens)
    esize = 2 if fmt == "none" else 1
    tokens = sum(lens)
    nbytes = (tokens * (d_c * esize + d_r * 2 + 4)
              + B * heads * (d_c * esize + d_r * 4 + 4)
              + B * (table_entries + 1) * 4
              + B * splits * heads * (d_c * 4 + 4 + (4 if splits > 1 else 0)))
    flops = tokens * heads * (2 * (d_c + d_r) + 2 * d_c)
    return _bound(nbytes, flops, PEAK[fmt])


def combine_bound(B, S, amla: bool, heads=H):
    """C reads o and lse partials, #4 also g; both write o and lse."""
    per_split = D_C + (2 if amla else 1)
    return _bound(B * S * heads * per_split * 4 + B * heads * (D_C + 1) * 4,
                  2 * B * S * heads * D_C, PEAK["f32"])


def _bound(nbytes, flops, peak):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def raw_query(gen, *lead):
    """A raw decode query (q_lat [*lead, D_C], q_rope [*lead, D_R], float32)
    on the card."""
    import torch
    return (torch.randn(*lead, D_C, generator=gen, device="cuda"),
            torch.randn(*lead, D_R, generator=gen, device="cuda"))


def d_query(raw, fmt, flat=None):
    """D as its own launch on a raw query of rank 3 or 4 (on ``flat``, its
    input from ``d_input``, when given): the prepared query the unfolded
    decode launches take."""
    from repro_torch.kernels.quantize import kernel as QK
    lead = raw[0].shape[:-1]
    out = QK.fused_q_quant_cuda(d_input(raw) if flat is None else flat, D_C, fmt=fmt)
    return out[0].reshape(*lead, D_C), out[1].reshape(*lead, D_R), out[2].reshape(lead)


def d_input(raw):
    """D's input, [q_lat | q_rope] as [B, rows, D_C + D_R]."""
    import torch
    return torch.cat(raw, -1).reshape(raw[0].shape[0], -1, D_C + D_R).contiguous()


def make_case(gen, fmt, lens, P, *, sink_tokens=0, extra=3, heads=H):
    """One random quantized cache held twice on the card: contiguous
    ([B, P*PAGE, .], with the sink guard's shadow when ``sink_tokens``) and as
    a shuffled page pool; plus a raw query of ``heads`` heads and its
    prepared form. Returns (prepared query, MLACache, PagedMLAPool, raw
    query)."""
    import torch
    from repro_torch.core.kvcache import (CacheConfig, MLACache, PagedMLAPool,
                                          mla_quantize_entry)
    from repro_torch.kernels.mla_decode.ref import prepare_q
    dev = "cuda"
    B, N = len(lens), P * PAGE
    c = torch.randn(B, N, D_C, generator=gen, device=dev)
    r = torch.randn(B, N, D_R, generator=gen, device=dev) * 2
    content, rope, scale = mla_quantize_entry(CacheConfig(fmt=fmt, page_size=PAGE), c, r)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    cache = MLACache(content.contiguous(), rope.contiguous(), scale.contiguous(), seq_lens,
                     c[:, :sink_tokens].contiguous() if sink_tokens else None)
    n_pool = B * P + extra
    table = torch.randperm(n_pool, generator=gen, device=dev)[: B * P].reshape(B, P)
    pool = []
    for x in (content, rope, scale):
        dst = torch.zeros((n_pool, PAGE) + x.shape[2:], dtype=x.dtype, device=dev)
        dst[table.reshape(-1)] = x.reshape((B * P, PAGE) + x.shape[2:])
        pool.append(dst)
    raw = raw_query(gen, B, heads)
    q = tuple(t.contiguous() for t in prepare_q(*raw, fmt))
    return q, cache, PagedMLAPool(*pool, table.to(torch.int32).contiguous(), seq_lens), raw


def _record(records, name, tag, S, err, fn=None, plain=None, bound=None):
    rec = records.setdefault((name, tag, S), {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if fn is not None:
        rec.update(ms=kernel_ms(fn), plain_ms=time_ms(plain), bound_ms=bound[0],
                   bound_by=bound[1])


def decode_checks(gen, fmt, lens, P, splits_list, scale, *, tag, timing, records,
                  layouts=("paged", "contiguous"), rescales=("fma", "amla"), sink_tokens=0,
                  heads=H):
    """Every decode kernel (A, B, #2, #1 in each rescale mode) and both
    combines (C, #4) against their plain versions on one case of ``heads``
    query heads; contiguous against paged bit for bit; single pass against
    one split bit for bit when every block is live; with ``timing``, ms /
    plain ms / bound ms."""
    import torch
    from repro_torch.core.kvcache import sink_patched_content
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode import ref as R
    q, cache, pool, raw = make_case(gen, fmt, lens, P, sink_tokens=sink_tokens, heads=heads)
    pgd = q + tuple(pool)
    ctg = q + (cache.content, cache.rope, cache.scale, cache.seq_lens)
    ctg_ref = q + (sink_patched_content(cache), cache.rope.float(), cache.scale,
                   cache.seq_lens)
    B = len(lens)
    for rescale in rescales:
        amla = rescale == "amla"
        o_tol, lse_tol = (AMLA_O, AMLA_LSE) if amla else (TOL, TOL)
        sfx = "_amla" if amla else ""
        kw = dict(softmax_scale=scale, fmt=fmt, rescale=rescale)
        ckw = dict(kw, block_n=PAGE, sink=cache.sink)
        for S in splits_list:
            outs = {}
            for layout in layouts:
                if layout == "paged":
                    name = "paged_splitkv_decode" + sfx
                    got = K.mla_decode_paged_splitkv_cuda(*pgd, num_splits=S,
                                                          return_partials=True, **kw)
                    want = R.snapmla_decode_paged_splitkv_ref(*pgd, num_splits=S,
                                                              return_partials=True, **kw)

                    def partials(S=S):
                        return K.paged_decode_partials_cuda(*pgd, num_splits=S,
                                                            single_pass=False, **kw)

                    def plain(S=S):
                        return R.snapmla_decode_paged_splitkv_ref(
                            *pgd, num_splits=S, return_partials=True, **kw)
                    table = P
                else:
                    name = "splitkv_decode" + sfx
                    got = K.mla_decode_splitkv_cuda(*ctg, num_splits=S, return_partials=True,
                                                    **ckw)
                    want = R.snapmla_decode_splitkv_ref(*ctg_ref, num_splits=S, block_n=PAGE,
                                                        return_partials=True, **kw)

                    def partials(S=S):
                        return K.decode_partials_cuda(*ctg, num_splits=S, single_pass=False,
                                                      **ckw)

                    def plain(S=S):
                        return R.snapmla_decode_splitkv_ref(*ctg_ref, num_splits=S,
                                                            block_n=PAGE,
                                                            return_partials=True, **kw)
                    table = 0
                (o, lse, parts), (o_r, lse_r, parts_r) = got, want
                lbl = f"{tag} {name} S={S}"
                width_gate(lbl, partials)
                fold_split(tag, name, fmt, rescale, S, layout, q, raw, pgd[3:] if layout ==
                           "paged" else ctg[3:], dict(kw, num_splits=S) if layout == "paged"
                           else dict(ckw, num_splits=S), time_it=S in splits_list[:1] +
                           splits_list[-1:])
                err = max(check_close(f"{lbl} o", o, o_r, equal_nan=True, **o_tol),
                          check_close(f"{lbl} lse", lse, lse_r, equal_nan=True, **lse_tol))
                if amla:   # g: integer grid exponents, exact
                    check_bitwise(f"{lbl} g", parts[2], parts_r[2])
                    check_close(f"{lbl} l", parts[1], parts_r[1], rtol=1e-5, atol=0.0)
                else:
                    err = max(err, check_close(f"{lbl} o_partial", parts[0], parts_r[0], **TOL),
                              check_close(f"{lbl} lse_partial", parts[1], parts_r[1], **TOL))
                    check_close(f"{lbl} sigma_p", parts[2], parts_r[2], rtol=1e-6, atol=0.0)
                timed = timing and S in splits_list[:1] + splits_list[-1:]
                _record(records, name, tag, S, err, partials if timed else None, plain,
                        decode_bound(lens, fmt, S, table, heads) if timed else None)
                outs[layout] = (o, lse) + tuple(parts)
                # the combine on these partials against its plain version
                cname = "amla_combine" if amla else "lse_combine"
                if amla:
                    oc, lc = K.amla_combine_cuda(*parts)
                    oc_r, lc_r = R.amla_combine_ref(*parts)
                else:
                    oc, lc = K.lse_combine_cuda(*parts[:2])
                    oc_r, lc_r = R.lse_combine_ref(*parts[:2])
                err_c = max(check_close(f"{lbl} {cname} o", oc, oc_r, equal_nan=True, **TOL),
                            check_close(f"{lbl} {cname} lse", lc, lc_r, equal_nan=True, **TOL))
                cfn = ((lambda p=parts: K.amla_combine_cuda(*p)) if amla
                       else (lambda p=parts: K.lse_combine_cuda(*p[:2])))
                cplain = ((lambda p=parts: R.amla_combine_ref(*p)) if amla
                          else (lambda p=parts: R.lse_combine_ref(*p[:2])))
                _record(records, cname, tag, S, err_c, cfn if timed else None, cplain,
                        combine_bound(B, S, amla, heads) if timed else None)
            if len(outs) == 2:   # contiguous == paged at block_n == page
                for a, b in zip(outs["contiguous"], outs["paged"]):
                    check_bitwise(f"{tag} {rescale} S={S} contiguous vs paged", a, b)
            emit(phase="kernels", case=tag, fmt=fmt, rescale=rescale, splits=S,
                 layouts=list(outs), bitwise_contiguous_vs_paged=len(outs) == 2,
                 bitwise_widths=True,
                 max_abs_err={k[0]: v["max_abs_err"] for k, v in records.items()
                              if k[1] == tag and k[2] == S})
        # single pass (B / #1), against its plain version (the empty row is
        # NaN / -inf in both) and against one split with every block live
        live = torch.full_like(cache.seq_lens, P * PAGE)
        live[1:] -= torch.arange(1, B, device="cuda", dtype=torch.int32) * 37 % PAGE
        outs = {}
        for layout in layouts:
            if layout == "paged":
                name = "paged_single_pass_decode" + sfx
                fn = lambda a=pgd: K.mla_decode_paged_cuda(*a, **kw)  # noqa: E731
                plain = lambda: R.snapmla_decode_paged_ref(*pgd, **kw)  # noqa: E731
                one = K.mla_decode_paged_splitkv_cuda(*pgd[:7], live, num_splits=1, **kw)
                single_live = K.mla_decode_paged_cuda(*pgd[:7], live, **kw)
                table = P
            else:
                name = "single_pass_decode" + sfx
                fn = lambda a=ctg: K.mla_decode_cuda(*a, **ckw)  # noqa: E731
                plain = lambda: R.snapmla_decode_pipeline_ref(  # noqa: E731
                    *ctg_ref, block_n=PAGE, **kw)
                one = K.mla_decode_splitkv_cuda(*ctg[:6], live, num_splits=1, **ckw)
                single_live = K.mla_decode_cuda(*ctg[:6], live, **ckw)
                table = 0
            o, lse = fn()
            o_r, lse_r = plain()
            width_gate(f"{tag} {name}", fn)
            if fmt != "none":   # D in the prologue of B / #1
                cache_args, call_kw = (pgd[3:], kw) if layout == "paged" else (ctg[3:], ckw)
                call = K.mla_decode_paged_cuda if layout == "paged" else K.mla_decode_cuda
                fold_gate(f"{tag} {name}", lambda: call(*raw, None, *cache_args, **call_kw),
                          lambda: call(*d_query(raw, fmt), *cache_args, **call_kw))
                entry = dict(case=tag, kernel=name, fmt=fmt, splits=1, folded="D")
                if not amla:
                    flat = d_input(raw)
                    fold_time(entry, lambda: call(*raw, None, *cache_args, **call_kw),
                              lambda: call(*q, *cache_args, **call_kw),
                              lambda: call(*d_query(raw, fmt, flat), *cache_args, **call_kw))
                FOLDS.append(entry)
            err = max(check_close(f"{tag} {name} o", o, o_r, equal_nan=True, **o_tol),
                      check_close(f"{tag} {name} lse", lse, lse_r, equal_nan=True, **lse_tol))
            for a, b in zip(single_live, one):
                check_bitwise(f"{tag} {name} vs one split", a, b)
            _record(records, name, tag, 1, err, fn if timing else None, plain,
                    decode_bound(lens, fmt, 1, table, heads) if timing else None)
            outs[layout] = (o, lse)
        if len(outs) == 2:
            for a, b in zip(outs["contiguous"], outs["paged"]):
                check_bitwise(f"{tag} {rescale} single pass contiguous vs paged", a, b)
        emit(phase="kernels", case=tag, fmt=fmt, rescale=rescale, kernel="single pass",
             layouts=list(outs), bitwise_vs_one_split=True,
             bitwise_contiguous_vs_paged=len(outs) == 2, bitwise_widths=True)
    if fmt != "none":   # D: bit-identical to its plain version
        from repro_torch.kernels.quantize import kernel as QK
        from repro_torch.kernels.quantize import ref as QR
        qin = torch.randn(B, heads, D_C + D_R, generator=gen, device="cuda") * 3
        got, want = QK.fused_q_quant_cuda(qin, D_C, fmt=fmt), QR.fused_q_quant_ref(qin, D_C, fmt)
        for nm, g, w in zip(("q_c8", "q_r", "sigma_q"), got, want):
            check_bitwise(f"{tag} D {nm}", g, w)
        bound = d_bound(B, heads)
        _record(records, "fused_q_quant", tag, 1, 0.0,
                (lambda: QK.fused_q_quant_cuda(qin, D_C, fmt=fmt)) if timing else None,
                lambda: QR.fused_q_quant_ref(qin, D_C, fmt), bound)


# A's sm90 design at the benchmark cells' shapes: (tag, batch, heads), pages
# of 128 tokens, 273 a row, contexts drawn from 16,384-32,768; its gates
# against the plain version: the mean over live (row, head) of |o - o_plain|
# / |o_plain| (2-norm over d_c; the design reads ~3e-4, its card tests) and
# the largest lse difference (the design reads ~3e-4)
SM90_CASES = (("cell_mla7b", 32, H), ("cell_dsv3", 64, DS_HEADS))
SM90_REL_MEAN, SM90_LSE = 2.0 ** -9, 2.0 ** -10


def sm90_checks(gen, scale, records):
    """A's sm90 design (``paged_splitkv_decode_sm90``: the wrapper's own
    route, the raw query's D folded, C folded) against the plain version at
    each cell's shape and the sm90 rule's split count, within SM90_REL_MEAN
    and SM90_LSE; ms beside the plain version's, the bound's and the exact
    design's (the same call pinned to it)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode import ref as R
    name, P = "paged_splitkv_decode_sm90", 273
    cases = []
    for tag, batch, heads in SM90_CASES:
        lens = torch.randint(16384, 32769, (batch,), generator=torch.Generator().manual_seed(
            batch)).tolist()
        q, _, pool, raw = make_case(gen, "fp8_e4m3", lens, P, extra=0, heads=heads)
        pgd = tuple(pool)
        S = K.sm90_num_splits(batch, heads, P * PAGE, PAGE, _lib.sm_count(0))
        kw = dict(softmax_scale=scale, num_splits=S)
        fn = lambda: K.mla_decode_paged_splitkv_cuda(*raw, None, *pgd, **kw)  # noqa: E731
        plain = lambda: R.snapmla_decode_paged_splitkv_ref(*q, *pgd, **kw)  # noqa: E731
        _lib.reset_launches()
        o, lse = fn()
        torch.cuda.synchronize()
        if dict(_lib.LAUNCHES) != {name: 1}:
            raise AssertionError(f"{tag}: launches {dict(_lib.LAUNCHES)}, not one {name}")
        o_r, lse_r = plain()
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{tag} {name}: non-finite output")
        rel = float(((o - o_r).norm(dim=-1) / o_r.norm(dim=-1)).mean())
        lse_err = float((lse - lse_r).abs().max())
        err = float((o - o_r).abs().max())
        if rel > SM90_REL_MEAN or lse_err > SM90_LSE:
            raise AssertionError(f"{tag} {name}: o relative error (mean) {rel} > "
                                 f"{SM90_REL_MEAN} or lse error {lse_err} > {SM90_LSE}")
        _record(records, name, tag, S, err, fn, plain, decode_bound(lens, "fp8_e4m3", S, P,
                                                                    heads))
        with K.forced_design("exact"):
            exact_ms = kernel_ms(fn)
        records[(name, tag, S)].update(tokens=sum(lens), heads=heads, batch=batch,
                                       rel_err_mean=rel, lse_max_err=lse_err,
                                       exact_ms=exact_ms)
        emit(phase="kernels", case=tag, kernel=name, batch=batch, heads=heads, splits=S,
             tokens=sum(lens), rel_err_mean=rel, rel_limit=SM90_REL_MEAN,
             lse_max_err=lse_err, lse_limit=SM90_LSE, **{k: records[(name, tag, S)][k] for k in
                                                      ("ms", "exact_ms", "plain_ms",
                                                       "bound_ms", "bound_by")})
        cases.append((tag, S))
        del q, pool, raw, pgd, o, lse, o_r, lse_r
        torch.cuda.empty_cache()
    SUMMARY_CASES[name] = tuple(cases)


def fold_split(tag, name, fmt, rescale, S, layout, q, raw, cache_args, call_kw, *, time_it):
    """One split call (A, #2 or K2) folded — D in the prologue for fp8 /
    int8, C (FMA) or #4 (AMLA) in the epilogue — against D, the split
    kernel, then C or #4, at every width (``fold_gate``); with ``time_it``
    its ms beside the unfolded kernel's and the replaced launches'
    (``fold_time``). ``q`` is the prepared query, ``raw`` the raw one (rank
    3 or 4)."""
    from repro_torch.kernels.mla_decode import kernel as K
    amla = rescale == "amla"
    paged = layout == "paged"
    call = K.mla_decode_paged_splitkv_cuda if paged else K.mla_decode_splitkv_cuda
    parts_call = K.paged_decode_partials_cuda if paged else K.decode_partials_cuda
    fq = q if fmt == "none" else raw + (None,)
    uq = q if fmt == "none" else d_query(raw, fmt)
    fold_gate(f"{tag} {name} S={S} {layout}", lambda: call(*fq, *cache_args, **call_kw),
              lambda: call(*uq, *cache_args, return_partials=True, **call_kw)[:2])
    merge = "#4" if amla else "C"
    entry = dict(case=tag, kernel=name, fmt=fmt, layout=layout, splits=S,
                 folded=merge if fmt == "none" else f"D + {merge}")
    if time_it:
        flat = None if fmt == "none" else d_input(raw)

        def kernel_then_merge(qq):
            qc, qr, sq, q_len, _ = K._flatten_q(*qq)
            parts = parts_call(qc, qr, sq, *cache_args, single_pass=False, q_len=q_len or 1,
                               **call_kw)
            return K.combine_cuda(parts, rescale)

        def kernel_alone(qq=q):
            qc, qr, sq, q_len, _ = K._flatten_q(*qq)
            return parts_call(qc, qr, sq, *cache_args, single_pass=False, q_len=q_len or 1,
                              **call_kw)

        # the two folds apart: D only (the raw query, the partials kept) and
        # the merge only (the prepared query, merged in the epilogue)
        parts = {"merge_only": lambda: call(*q, *cache_args, **call_kw)}
        if fmt != "none":
            parts["d_only"] = lambda: kernel_alone(raw + (None,))
        fold_time(entry, lambda: call(*fq, *cache_args, **call_kw), kernel_alone,
                  lambda: kernel_then_merge(q if flat is None else d_query(raw, fmt, flat)),
                  **parts)
    FOLDS.append(entry)


def k_append_checks(gen, fmt, B, N, *, tag, timing, records):
    """#9: cache bytes bitwise equal to the plain Fused-K-Append (ragged
    write rows, one past capacity, the EPS floor), and 64 sequential appends
    equal to a prefill (sink shadow included)."""
    import torch
    from repro_torch.core.kvcache import CacheConfig, MLACache, init_mla_cache, mla_prefill
    from repro_torch.kernels.quantize import kernel as QK
    from repro_torch.kernels.quantize import ref as QR
    from repro_torch.kernels.quantize.ops import fused_k_append
    cfg = CacheConfig(fmt=fmt, page_size=PAGE)
    cache = mla_prefill(init_mla_cache(cfg, B, N, D_C, D_R, device="cuda"), cfg,
                        torch.randn(B, N, D_C, generator=gen, device="cuda"),
                        torch.randn(B, N, D_R, generator=gen, device="cuda") * 2)
    lens = torch.randint(0, N, (B,), generator=gen, device="cuda", dtype=torch.int32)
    lens[-1] = N + 1                                  # clamped to the last row
    c = torch.randn(B, D_C, generator=gen, device="cuda") * 3
    r = torch.randn(B, D_R, generator=gen, device="cuda") * 10
    c[0] = 0.0                                        # the EPS floor
    plain_cache = MLACache(*(t.clone() for t in cache[:4]))
    QK.fused_k_append_cuda(cache.content, cache.rope, cache.scale, c, r, lens, fmt=fmt)
    QR.fused_k_append_ref(plain_cache.content, plain_cache.rope, plain_cache.scale, c, r,
                          lens, fmt=fmt)
    for nm, a, b in zip(("content", "rope", "scale"), cache, plain_cache):
        check_bitwise(f"{tag} #9 {nm}", a, b)
    S = 64
    scfg = CacheConfig(fmt=fmt, page_size=PAGE, sink_tokens=4)
    cs = torch.randn(B, S, D_C, generator=gen, device="cuda") * 2
    rs = torch.randn(B, S, D_R, generator=gen, device="cuda") * 20
    bulk = mla_prefill(init_mla_cache(scfg, B, S, D_C, D_R, device="cuda"), scfg, cs, rs)
    inc = init_mla_cache(scfg, B, S, D_C, D_R, device="cuda")
    for t in range(S):
        inc = fused_k_append(inc, cs[:, t], rs[:, t], fmt=fmt)
    for nm, a, b in zip(bulk._fields, inc, bulk):
        check_bitwise(f"{tag} #9 appends vs prefill {nm}", a, b)
    bound = _bound(B * ((D_C + D_R) * 4 + 4 + D_C + 2 * D_R + 4), B * (3 * D_C + D_R),
                   PEAK["f32"])
    # timed on entries with no all-zero row, as a decode step appends them;
    # the gate's entries (row 0 at the EPS floor) are timed beside them
    ct = torch.randn(B, D_C, generator=gen, device="cuda") * 3
    rt = torch.randn(B, D_R, generator=gen, device="cuda") * 10
    _record(records, "fused_k_append", tag, 1, 0.0,
            (lambda: QK.fused_k_append_cuda(cache.content, cache.rope, cache.scale, ct, rt,
                                            lens, fmt=fmt)) if timing else None,
            lambda: QR.fused_k_append_ref(plain_cache.content, plain_cache.rope,
                                          plain_cache.scale, ct, rt, lens, fmt=fmt), bound)
    if timing:
        records[("fused_k_append", tag, 1)]["ms_eps_row"] = kernel_ms(
            lambda: QK.fused_k_append_cuda(cache.content, cache.rope, cache.scale, c, r, lens,
                                           fmt=fmt))
    emit(phase="kernels", case=tag, fmt=fmt, kernel="#9 fused_k_append", bitwise=True,
         appends_equal_prefill=True)


def d_bound(B, heads, d_c=D_C, d_r=D_R):
    """D reads each row once and writes its codes, rope quotients and sigma
    once; a max, a division and a cast per value at the float32 rate."""
    return _bound(B * heads * ((d_c + d_r) * 4 + d_c + d_r * 4 + 4),
                  3 * B * heads * (d_c + d_r), PEAK["f32"])


def rotating(inputs, fn, keep):
    """A call of ``fn`` on the next of ``inputs`` (in turn) whose outputs are
    kept in ``keep``: captured ``inner`` times into kernel_ms's graph, no two
    neighbouring launches of a replay share an input and none shares an
    output, so with three 18.9 MB inputs of D (deepseek_b64) a replay touches
    far more than the 50 MB L2 and each launch finds its rows cold."""
    turn = itertools.count()

    def call():
        keep.append(fn(inputs[next(turn) % len(inputs)]))
    return call


# D's cases: (tag, batch, heads, d_c, d_r); the full widths' rows at the
# layer API's shapes and deepseek-v3-mla's batch 64, then runtime widths
D_CASES = [("serve_shape", 4, H, D_C, D_R), ("serve_shape_h128", 4, DS_HEADS, D_C, D_R),
           ("deepseek_b64", 64, DS_HEADS, D_C, D_R), ("ragged", 3, 9, D_C, D_R),
           ("runtime_96_32", 3, 9, 96, 32), ("runtime_32_16", 1, 4, 32, 16),
           ("runtime_512_32", 2, 5, D_C, 32)]
# #9's cases beyond k_append_checks': (tag, batch, capacity, d_c, d_r)
K9_CASES = [("runtime_96_32", 3, 64, 96, 32), ("runtime_32_16", 5, 16, 32, 16)]


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is not 16-byte aligned:
    a view one element into its buffer."""
    import torch
    one_byte = t.element_size() == 1
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8 if one_byte else t.dtype, device=t.device)
    out = buf[1:].view(t.dtype).view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 == 0:
        raise AssertionError("an unaligned view came out aligned")
    return out


def token_prep_checks(gen, records):
    """D and #9 bitwise against their plain versions at every instantiation:
    the full widths (B x H not a multiple of D's rows per block too),
    runtime widths, and views whose pointer is not 16-byte
    aligned (the runtime-width instantiation), each with an EPS-floor row,
    fp8 and int8; the plan each launch took; D timed at deepseek_b64 with
    its L2 cold; the launch floor; the ptxas line of both kernels."""
    import torch
    from repro_torch.kernels.quantize import kernel as QK
    from repro_torch.kernels.quantize import ref as QR
    plans = {}
    for fmt in ("fp8_e4m3", "int8"):
        for tag, B, heads, d_c, d_r in D_CASES:
            q = torch.randn(B, heads, d_c + d_r, generator=gen, device="cuda") * 3
            q[0, 0, :d_c] = 0.0                                     # the EPS floor
            want = QR.fused_q_quant_ref(q, d_c, fmt)
            plans[f"D {tag}"] = QK.token_prep_plan("q_quant", B * heads, d_c, d_r, True)
            for label, copy in (("aligned", torch.clone), ("unaligned", _unaligned)):
                for nm, g, x in zip(("q_c8", "q_r", "sigma_q"),
                                    QK.fused_q_quant_cuda(copy(q), d_c, fmt=fmt), want):
                    check_bitwise(f"D {tag} {fmt} {label} {nm}", g, x)
        for tag, B, N, d_c, d_r in K9_CASES + [("full", 4, 640, D_C, D_R)]:
            content = torch.zeros(B, N, d_c, dtype=torch.uint8, device="cuda").view(
                torch.float8_e4m3fn if fmt == "fp8_e4m3" else torch.int8)
            rope = torch.zeros(B, N, d_r, dtype=torch.bfloat16, device="cuda")
            scale = torch.zeros(B, N, device="cuda")
            c = torch.randn(B, d_c, generator=gen, device="cuda") * 3
            r = torch.randn(B, d_r, generator=gen, device="cuda") * 10
            c[0] = 0.0                                              # the EPS floor
            lens = torch.randint(0, N, (B,), generator=gen, device="cuda", dtype=torch.int32)
            lens[-1] = N + 2                                        # clamped to the last row
            want = [t.clone() for t in (content, rope, scale)]
            QR.fused_k_append_ref(*want, c, r, lens, fmt=fmt)
            plans[f"#9 {tag}"] = QK.token_prep_plan("k_append", B, d_c, d_r, True)
            for label, copy in (("aligned", torch.clone), ("unaligned", _unaligned)):
                got = [copy(t) for t in (content, rope, scale)]
                QK.fused_k_append_cuda(*got, copy(c), copy(r), lens, fmt=fmt)
                for nm, g, x in zip(("content", "rope", "scale"), got, want):
                    check_bitwise(f"#9 {tag} {fmt} {label} {nm}", g, x)
    # D at deepseek-v3-mla's widths and batch 64, L2 cold; D on an EPS-floor
    # row at the serving shape; the launch floor
    B, heads = 64, DS_HEADS
    inputs = [torch.randn(B, heads, D_C + D_R, generator=gen, device="cuda") * 3
              for _ in range(3)]
    keep: list = []
    rec = records.setdefault(("fused_q_quant", "deepseek_b64", 1), {"max_abs_err": 0.0})
    bound = d_bound(B, heads)
    rec.update(ms=kernel_ms(rotating(inputs, lambda q: QK.fused_q_quant_cuda(q, D_C), keep)),
               plain_ms=time_ms(lambda: QR.fused_q_quant_ref(inputs[0], D_C, "fp8_e4m3")),
               bound_ms=bound[0], bound_by=bound[1], l2="cold: 3 inputs, every output kept")
    keep.clear()
    q = torch.randn(4, H, D_C + D_R, generator=gen, device="cuda") * 3
    q[0, 0, :D_C] = 0.0
    rec = records.setdefault(("fused_q_quant", "serve_shape", 1), {"max_abs_err": 0.0})
    rec["ms_eps_row"] = kernel_ms(lambda: QK.fused_q_quant_cuda(q, D_C))
    floor = torch.zeros(1, device="cuda")
    launch_floor = kernel_ms(lambda: floor.add_(1.0))
    for name in ("fused_q_quant", "fused_k_append"):
        for k, v in records.items():
            if k[0] == name:
                v["launch_floor_ms"] = launch_floor
    emit(phase="kernels", check="launch_floor", what="in-place add on a 1-element tensor",
         ms=launch_floor)
    emit(phase="kernels", check="D / #9 instantiations", bitwise=True, fmts=["fp8_e4m3", "int8"],
         rows_per_block=QK.Q_ROWS_PER_BLOCK, plans=plans, ptxas=token_prep_ptxas(),
         ms={f"{k[0]} {k[1]}": {f: v.get(f) for f in ("ms", "ms_eps_row", "plain_ms", "bound_ms")}
             for k, v in records.items() if k[0] in ("fused_q_quant", "fused_k_append")
             and "ms" in v},
         launch_floor_ms=launch_floor)


def fetch_bound(B, P, live_pages, paged: bool):
    """K1 reads each live page once (content, rope, scale; plus the table and
    chunk_start when paged) and writes the whole bf16 output once; one
    multiply per live value at the float32 rate."""
    nbytes = (live_pages * PAGE * (D_C + 2 * D_R + 4)
              + B * P * PAGE * (D_C + D_R) * 2 + ((B * P + B) * 4 if paged else 0))
    return _bound(nbytes, live_pages * PAGE * (D_C + D_R), PEAK["f32"])


def fetch_checks(gen, records, engine_pages):
    """K1 bitwise against its plain version: paged in full and bounded mode
    (dead pages all zero, live pages equal to the full fetch) and its
    contiguous mode, at ~32k tokens (B = 4, 256 pages of 128, shuffled pool)
    and at the engine's shape (B = 1, E2's span, its last chunk's start), at
    the pick of ``fetch_geometry`` and at every tokens per warp the kernel
    takes (each one's ms beside the pick)."""
    import contextlib
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quantize import fetch_dequant as FD
    cases = (("long_32k", [0, PAGE, 32768, 20000], 256, [0, 1000, 20000, 32768]),
             ("engine_shape", [1000], engine_pages, [768]))
    for tag, lens, P, starts in cases:
        _, cache, pool, _ = make_case(gen, "fp8_e4m3", lens, P)
        cs = torch.tensor(starts, dtype=torch.int32, device="cuda")
        full_ref = FD.paged_fetch_dequant_ref(pool)
        bounded_ref = FD.paged_fetch_dequant_ref(pool, chunk_start=cs)
        contig_ref = FD.fetch_dequant_ref(cache)
        ms_by_tpw = {}
        for tpw in (None,) + FD.TOKENS_PER_WARP:
            with FD.forced_tokens_per_warp(tpw) if tpw else contextlib.nullcontext():
                full = FD.paged_fetch_dequant(pool)
                check_bitwise(f"{tag} #11 full tpw={tpw}", full, full_ref)
                got = FD.paged_fetch_dequant(pool, chunk_start=cs)
                check_bitwise(f"{tag} #11 bounded tpw={tpw}", got, bounded_ref)
                for b, c0 in enumerate(starts):
                    dead = -(-c0 // PAGE) * PAGE
                    if torch.count_nonzero(got[b, dead:]):
                        raise AssertionError(f"{tag} #11: dead pages of row {b} not zero")
                    check_bitwise(f"{tag} #11 row {b} live pages", got[b, :dead],
                                  full[b, :dead])
                check_bitwise(f"{tag} #10 tpw={tpw}", FD.fetch_dequant(cache, page=PAGE),
                              contig_ref)
                if tpw:
                    ms_by_tpw[tpw] = kernel_ms(lambda: FD.paged_fetch_dequant(pool,
                                                                              chunk_start=cs))
        B = len(lens)
        live = sum(-(-c0 // PAGE) for c0 in starts)
        _record(records, "paged_fetch_dequant", tag, 0, 0.0,
                lambda: FD.paged_fetch_dequant(pool, chunk_start=cs),
                lambda: FD.paged_fetch_dequant_ref(pool, chunk_start=cs),
                fetch_bound(B, P, live, True))
        _record(records, "fetch_dequant", tag, 0, 0.0, lambda: FD.fetch_dequant(cache, page=PAGE),
                lambda: FD.fetch_dequant_ref(cache), fetch_bound(B, P, B * P, False))
        tpw, grid = FD.fetch_geometry(B, P, PAGE, _lib.sm_count(0))
        emit(phase="kernels", case=tag, kernel="fetch_dequant", batch=B, pages=P,
             chunk_start=starts, live_pages=live, bitwise=True, dead_pages_zero=True,
             tokens_per_warp=tpw, grid=grid, bounded_ms_by_tokens_per_warp=ms_by_tpw,
             ptxas=fetch_ptxas(),
             ms={k[0]: records[k]["ms"] for k in records if k[1] == tag and k[2] == 0})


def verify_bound(lens, q_len, S, table_entries, heads=H):
    """Least time for one fp8 verify call: each live token read once, the
    R = q_len*heads query rows and the partials moved once; QK + PV
    operations for each row over its own limit."""
    B, R = len(lens), q_len * heads
    nbytes = (sum(lens) * (D_C + D_R * 2 + 4) + B * R * (D_C + D_R * 4 + 4)
              + B * (table_entries + 1) * 4 + B * S * R * (D_C * 4 + 8))
    row_tokens = sum(max(0, n - (q_len - 1) + t) for n in lens for t in range(q_len))
    return _bound(nbytes, row_tokens * heads * (2 * (D_C + D_R) + 2 * D_C),
                  PEAK["fp8_e4m3"])


def verify_query(gen, B, q_len, fmt="fp8_e4m3", heads=H):
    """A [B, q_len, heads, .] verify block: (prepared query, raw query)."""
    from repro_torch.kernels.mla_decode.ref import prepare_q
    raw = raw_query(gen, B, q_len * heads)
    q = prepare_q(*raw, fmt)
    return (tuple(t.reshape(B, q_len, heads, *t.shape[2:]).contiguous() for t in q),
            tuple(t.reshape(B, q_len, heads, -1) for t in raw))


def verify_checks(gen, lens, P, q_len, splits_list, scale, *, tag, records, heads=H):
    """The q_len > 1 mode of A (#6) and #2, FMA and AMLA, against the plain
    version within the reference's gates; contiguous bitwise equal to paged;
    each row bitwise equal to the q_len = 1 kernel at its limit (rows with a
    limit <= 0 excepted: the reference's oracles give NaN there); timed at
    the first and last split count beside A at q_len = 1 on the same cache."""
    import torch
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode import ref as R
    _, cache, pool, _ = make_case(gen, "fp8_e4m3", lens, P, heads=heads)
    q, raw = verify_query(gen, len(lens), q_len, heads=heads)
    pgd, ctg = q + tuple(pool), q + (cache.content, cache.rope, cache.scale, cache.seq_lens)
    for rescale in ("fma", "amla"):
        amla = rescale == "amla"
        o_tol, lse_tol = (AMLA_O, AMLA_LSE) if amla else (TOL, TOL)
        sfx = "_amla" if amla else ""
        kw = dict(softmax_scale=scale, fmt="fp8_e4m3", rescale=rescale)
        for S in splits_list:
            o, lse, parts = K.mla_decode_paged_splitkv_cuda(*pgd, num_splits=S,
                                                            return_partials=True, **kw)
            o_r, lse_r, parts_r = R.snapmla_decode_paged_splitkv_ref(
                *pgd, num_splits=S, return_partials=True, **kw)
            lbl = f"{tag} verify q_len={q_len} {rescale} S={S}"
            width_gate(lbl, lambda S=S: K.mla_decode_paged_splitkv_cuda(
                *pgd, num_splits=S, return_partials=True, **kw))
            width_gate(f"{lbl} contiguous", lambda S=S: K.mla_decode_splitkv_cuda(
                *ctg, num_splits=S, block_n=PAGE, return_partials=True, **kw))
            err = max(check_close(f"{lbl} o", o, o_r, equal_nan=True, **o_tol),
                      check_close(f"{lbl} lse", lse, lse_r, equal_nan=True, **lse_tol))
            if amla:
                check_bitwise(f"{lbl} g", parts[2], parts_r[2])
            timed = S in splits_list[:1] + splits_list[-1:]
            fold_split(tag, "paged_splitkv_decode_verify" + sfx, "fp8_e4m3", rescale, S,
                       "paged", q, raw, tuple(pool), dict(kw, num_splits=S), time_it=timed)
            fold_split(tag, "splitkv_decode_verify" + sfx, "fp8_e4m3", rescale, S,
                       "contiguous", q, raw, ctg[3:], dict(kw, num_splits=S, block_n=PAGE),
                       time_it=timed)
            oc, lc, parts_c = K.mla_decode_splitkv_cuda(*ctg, num_splits=S, block_n=PAGE,
                                                        return_partials=True, **kw)
            for a, b in zip((oc, lc) + tuple(parts_c), (o, lse) + tuple(parts)):
                check_bitwise(f"{lbl} contiguous vs paged", a, b)
            for t in range(q_len):
                row_lens = torch.clamp(pool.seq_lens - (q_len - 1 - t), min=0).to(torch.int32)
                o1, l1 = K.mla_decode_paged_splitkv_cuda(
                    *(x[:, t].contiguous() for x in q), *tuple(pool)[:4], row_lens,
                    num_splits=S, **kw)
                ok = row_lens > 0
                check_bitwise(f"{lbl} row {t} vs q_len=1", o[ok, t], o1[ok])
                check_bitwise(f"{lbl} row {t} lse vs q_len=1", lse[ok, t], l1[ok])
            for name in ("paged_splitkv_decode_verify" + sfx, "splitkv_decode_verify" + sfx):
                rec = records.setdefault((name, tag, S), {"max_abs_err": 0.0})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if S in splits_list[:1] + splits_list[-1:]:
                qf = K._flatten_q(*q)
                bound = verify_bound(lens, q_len, S, P, heads)
                _record(records, "paged_splitkv_decode_verify" + sfx, tag, S, err,
                        lambda S=S: K.paged_decode_partials_cuda(
                            *qf[:3], *pool, num_splits=S, single_pass=False,
                            q_len=q_len, **kw),
                        lambda S=S: R.snapmla_decode_paged_splitkv_ref(
                            *pgd, num_splits=S, return_partials=True, **kw), bound)
                _record(records, "splitkv_decode_verify" + sfx, tag, S, err,
                        lambda S=S: K.decode_partials_cuda(
                            *qf[:3], *ctg[3:], num_splits=S, block_n=PAGE,
                            single_pass=False, q_len=q_len, **kw),
                        lambda S=S: R.snapmla_decode_splitkv_ref(
                            *q, cache.content, cache.rope.float(), cache.scale,
                            cache.seq_lens, num_splits=S, block_n=PAGE,
                            return_partials=True, **kw), verify_bound(lens, q_len, S, 0, heads))
                last = tuple(x[:, -1].contiguous() for x in q)   # A, q_len = 1, same cache
                a_ms = kernel_ms(lambda S=S: K.paged_decode_partials_cuda(
                    *last, *pool, num_splits=S, single_pass=False, **kw))
                records[("paged_splitkv_decode" + sfx, tag, S)] = {
                    "max_abs_err": 0.0, "ms": a_ms, "plain_ms": None,
                    "bound_ms": decode_bound(lens, "fp8_e4m3", S, P, heads)[0],
                    "bound_by": "bytes"}
            emit(phase="kernels", case=tag, kernel="verify", q_len=q_len, rescale=rescale,
                 splits=S, lens=lens, rows=q_len * heads, max_abs_err=err,
                 bitwise_contiguous_vs_paged=True, bitwise_rows_vs_q_len_1=True,
                 bitwise_widths=True)
    emit(phase="kernels", case=tag, kernel="verify timing", q_len=q_len,
         ms={f"{k[0]} S={k[2]}": v.get("ms") for k, v in records.items()
             if k[1] == tag and v.get("ms") is not None})


def width_sweep(gen, scale, heads=H, sfx="") -> None:
    """Each head-tile width's ms for B (paged single pass), A (paged split)
    and K2 (the verify mode) at the serving shape and at ~32k with ``heads``
    query heads, beside the width ``head_width`` picks there: one line."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    sms = _lib.sm_count(0)
    rows = []
    for tag, lens, P, q_len, S_a, S_v in (("serve_shape", [527, 512, 520, 513], 5, 5, 4, 1),
                                          ("long_32k", [0, PAGE, 32768, 20000], 256, 4, 8, 8)):
        tag += sfx
        q, cache, pool, _ = make_case(gen, "fp8_e4m3", lens, P, heads=heads)
        qv = K._flatten_q(*verify_query(gen, len(lens), q_len, heads=heads)[0])[:3]
        kw = dict(softmax_scale=scale, fmt="fp8_e4m3")
        B = len(lens)
        cases = {
            "B": (lambda: K.paged_decode_partials_cuda(*q, *pool, num_splits=1,
                                                       single_pass=True, **kw), heads, 1),
            f"A S={S_a}": (lambda: K.paged_decode_partials_cuda(
                *q, *pool, num_splits=S_a, single_pass=False, **kw), heads, S_a),
            f"K2 q_len={q_len} S={S_v}": (lambda: K.paged_decode_partials_cuda(
                *qv, *pool, num_splits=S_v, single_pass=False, q_len=q_len, **kw),
                q_len * heads, S_v)}
        for name, (fn, n_rows, S) in cases.items():
            ms = {}
            for w in K.HEAD_WIDTHS:
                with K.forced_head_width(w):
                    ms[w] = kernel_ms(fn)
            rows.append(dict(case=tag, kernel=name, ms_by_width=ms,
                             picked=K.head_width(B, n_rows, S, sms)))
    emit(phase="kernels", check="head-tile widths", heads=heads, sms=sms, widths=rows)


def ptxas_entries(log: str) -> dict:
    """Entry function -> (registers, spill bytes), from nvcc's -Xptxas -v
    report; the spill bytes (stores and loads) are the entry's own and those
    of the functions it calls (None where the report gives none)."""
    rows = {}
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        rows[block.split("'", 1)[0]] = (int(regs[1]) if regs else None,
                                        sum(int(a) + int(b) for a, b in spills) if spills
                                        else None)
    return rows


def no_verify_checks(gen, variant, scale):
    """The q_len = 1 launches (A, B, #2, #1, FMA and AMLA) bitwise equal to
    the same launches through a build without the verify code, and their
    register counts equal in the two builds."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    main_regs = {k: v[0] for k, v in ptxas_entries(_lib.BUILD_LOG).items()}
    var_regs = {k: v[0] for k, v in ptxas_entries(_lib.VARIANT_LOGS.get(NO_VERIFY, "")).items()}
    dec = {k: v for k, v in var_regs.items() if "decode_kernel" in k}
    if not dec:
        raise AssertionError("no ptxas report of the build without the verify code")
    diff = {k: (v, main_regs.get(k)) for k, v in dec.items() if main_regs.get(k) != v}
    if diff:
        raise AssertionError(f"q_len = 1 register counts differ from the build without "
                             f"the verify code: {diff}")
    verify_only = sorted(set(k for k in main_regs if "decode_kernel" in k) - set(dec))
    q, cache, pool, _ = make_case(gen, "fp8_e4m3", [527, 512, 520, 513], 5)
    pgd, ctg = q + tuple(pool), q + (cache.content, cache.rope, cache.scale, cache.seq_lens)
    calls = []
    for rescale in ("fma", "amla"):
        kw = dict(softmax_scale=scale, rescale=rescale)
        calls += [lambda kw=kw: K.mla_decode_paged_splitkv_cuda(*pgd, num_splits=4, **kw),
                  lambda kw=kw: K.mla_decode_paged_cuda(*pgd, **kw),
                  lambda kw=kw: K.mla_decode_splitkv_cuda(*ctg, num_splits=4, block_n=PAGE, **kw),
                  lambda kw=kw: K.mla_decode_cuda(*ctg, block_n=PAGE, **kw)]
    for w in K.HEAD_WIDTHS:
        with K.forced_head_width(w):
            for i, call in enumerate(calls):
                got = call()
                with _lib.using(variant):
                    want = call()
                for a, b in zip(got, want):
                    check_bitwise(f"q_len = 1 launch {i} at width {w} vs the build without "
                                  "the verify code", a, b)
    emit(phase="kernels", check="q_len = 1 without the verify code", launches=len(calls),
         widths=list(K.HEAD_WIDTHS), bitwise=True, registers_equal=True,
         registers={k[:60]: v for k, v in sorted(dec.items())},
         verify_instantiations={k[:60]: main_regs[k] for k in verify_only})



SWEEP_PROFILE = "build/chip_smoke_splits_profile.json"   # never the committed profile


def phase_autotune() -> None:
    """One split sweep of the autotuner (``autotune.measure_split_sweep``):
    the paged decode kernels at mla-7b's serving shape (batch 4, capacity
    640, 528 tokens, 32 heads, FMA), each candidate split count as
    CUDA-graph replays, saved into its own file under ``build/``; loaded
    back, the port's resolution rule returns that sweep's best. The
    in-process profile is then dropped, so later phases read the committed
    one again."""
    import torch
    from repro_torch.kernels.mla_decode import autotune, ops
    path = ROOT / SWEEP_PROFILE
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    prof = autotune.SplitProfile(device={"name": torch.cuda.get_device_name(0)})
    measured = autotune.measure_split_sweep(640, PAGE, 4, d_c=D_C, d_r=D_R, heads=H,
                                            fill=528 / 640, layout="paged", profile=prof,
                                            device="cuda")
    prof.save(path)
    loaded = autotune.SplitProfile.load(path)
    best = loaded.lookup(640, PAGE, 4, layout="paged")
    try:
        autotune.reset(loaded)
        resolved = ops.resolve_num_splits(None, 640, PAGE, 4, "paged")
    finally:
        autotune.reset()
    if best != autotune._pick_best(measured) or resolved != best:
        raise AssertionError(f"autotune: sweep {measured} best {best}, resolved {resolved}")
    emit(phase="autotune", shape=dict(capacity=640, block_n=PAGE, batch=4, heads=H,
                                      tokens=528, layout="paged", rescale="fma"),
         measured_us=measured, best=best, resolved=resolved, file=SWEEP_PROFILE,
         seconds=time.time() - t0)


# phase 3: its own generator, so that its draw does not move with phase 2's
# random numbers. The gate's limit on the kernel step's error against the
# parallel reference backend, relative to the largest output: over 1,121
# draws of this layer on an NVIDIA H100 (scripts/diagnose_token_prep.py
# layer) the kernel step read 2.3e-7 to 5.0e-7 from the kernels' plain
# version and up to 4.3e-4 from the reference, as the plain version did (P
# rounded to fp8 from differently rounded logits); the control, the
# reference on h_t rounded to bfloat16, read 8.4e-3 or more. The limit lies
# between, and a control within it fails the phase.
LAYER_SEED = 1234
LAYER_B, LAYER_CTX = 4, 32760
LAYER_LIMIT = 1e-3


def layer_inputs(gen):
    """Phase 3's full-width mla-7b layer, drawn from ``gen``: (config,
    params, latents c [B, ctx, d_c], rope r, the decoded token's h_t)."""
    import torch
    from repro_torch.core import mla as mla_lib
    mcfg = mla_lib.MLAConfig(d_model=4096, n_heads=H, d_head=128, d_rope=D_R, d_c=D_C)
    params = mla_lib.init_mla_params(gen, mcfg, device="cuda")
    c = torch.randn(LAYER_B, LAYER_CTX, D_C, generator=gen, device="cuda")
    r = torch.randn(LAYER_B, LAYER_CTX, D_R, generator=gen, device="cuda") * 2
    h_t = torch.randn(LAYER_B, 4096, generator=gen, device="cuda")
    return mcfg, params, c, r, h_t


def layer_cache(cfg, c, r):
    """A cache (paged when ``cfg.paged``) prefilled with ``c``, ``r``."""
    from repro_torch.core import snapmla
    from repro_torch.core.kvcache import mla_prefill, paged_mla_prefill
    fill = paged_mla_prefill if cfg.paged else mla_prefill
    return fill(snapmla.init_cache(cfg, LAYER_B, LAYER_CTX + 8, device="cuda"), cfg.cache, c, r)


def rel_err(y, ref) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def phase_layer():
    """One full-width SnapMLA layer, decode_step over a ~32k-token cache,
    paged and contiguous: the kernel steps are this path's counted run, held
    within LAYER_LIMIT of the parallel reference backend (use_kernel=False),
    the contiguous cache bytes to the plain append's. Beside it, a control:
    the reference on h_t rounded to bfloat16, against the reference on h_t."""
    import torch
    from repro_torch.core import snapmla
    from repro_torch.kernels import _lib
    mcfg, params, c, r, h_t = layer_inputs(torch.Generator(device="cuda").manual_seed(LAYER_SEED))
    launches = {}
    for paged in (True, False):
        cfg = snapmla.SnapMLAConfig(mla=mcfg, paged=paged)
        cache = layer_cache(cfg, c, r)
        ref_cache = type(cache)(*(None if t is None else t.clone() for t in cache))
        ctl_cache = type(cache)(*(None if t is None else t.clone() for t in cache))
        torch.cuda.synchronize()
        _lib.reset_launches()                       # the layer path starts here
        y, cache = snapmla.decode_step(params, cfg, h_t, cache)
        torch.cuda.synchronize()
        for k, v in _lib.LAUNCHES.items():          # ... and ends here
            launches[k] = launches.get(k, 0) + v
        step_launches = dict(_lib.LAUNCHES)
        ref_cfg = dataclasses.replace(cfg, use_kernel=False)
        y_ref, ref_cache = snapmla.decode_step(params, ref_cfg, h_t, ref_cache)
        y_ctl, _ = snapmla.decode_step(params, ref_cfg, h_t.bfloat16().float(), ctl_cache)
        rel, ctl = rel_err(y, y_ref), rel_err(y_ctl, y_ref)
        if not (torch.isfinite(y).all() and rel <= LAYER_LIMIT):
            raise AssertionError(f"layer decode_step (paged={paged}): relative error {rel} > "
                                 f"{LAYER_LIMIT}")
        if ctl <= LAYER_LIMIT:
            raise AssertionError(f"layer (paged={paged}): the bfloat16 control's error {ctl} is "
                                 f"within the limit {LAYER_LIMIT}")
        if not paged:   # Fused-K-Append wrote what the plain append wrote
            for nm, a, b in zip(cache._fields[:4], cache, ref_cache):
                check_bitwise(f"layer contiguous cache {nm}", a, b)
        emit(phase="layer", layout="paged" if paged else "contiguous", batch=LAYER_B,
             context=LAYER_CTX + 1, capacity=cache.capacity, seed=LAYER_SEED, rel_err_vs_ref=rel,
             limit=LAYER_LIMIT, control_bf16_h_rel_err=ctl,
             cache_bytes_equal_plain_append=not paged, kernels_launched=step_launches)
        del cache, ref_cache, ctl_cache
    return launches


SERVE_RUNS = [  # (paged, kv_splits, rescale, sink_tokens)
    (False, 0, "fma", 0), (False, 4, "fma", 0), (False, 4, "amla", 0), (False, 0, "fma", 4),
    (False, 0, "amla", 0), (True, 0, "fma", 0), (True, 4, "fma", 0), (True, 0, "amla", 0),
    (True, 4, "amla", 0)]
# the serve runs repeated through serve.generate_fused (phases 4 and 9)
FUSED_RUNS = [(True, 0, "fma", 0), (True, 4, "fma", 0), (True, 4, "amla", 0),
              (False, 0, "fma", 0)]


def init_full(arch, layers=0):
    """``arch`` at full width (depth cut to ``layers`` when non-zero), float32
    weights from a seeded generator on the card, and a batch of 4 prompts of
    512 tokens; one ``serve_init`` line with the parameters held (beside the
    config's count, which leaves out the norms) and the memory they take."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    base = get_config(arch)
    if layers:
        base = dataclasses.replace(base, n_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    params = T.init_model(gen, base, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase="serve_init", arch=arch, layers=base.n_layers, params=n_params,
         config_param_count=base.param_count(), active_params=base.active_param_count(),
         seconds=time.time() - t0,
         gib=torch.cuda.memory_allocated() / 2**30)
    prompts = torch.randint(0, base.vocab_size, (4, 512), generator=gen, device="cuda")
    return base, params, prompts


def phase_serve():
    """Full mla-7b through serve.generate: kernel backend vs reference, both
    cache layouts; then serve.generate_fused on ``FUSED_RUNS`` against the
    step loop's kernel runs. The kernel runs and the fused runs are this
    path's counted runs."""
    base, params, prompts = init_full("mla-7b")
    launches, kern, refs = serve_runs(base, params, prompts, SERVE_RUNS)
    for run in FUSED_RUNS:
        _add(launches, fused_gate(f"mla-7b {run}", serve_cfg(base, run, "kernel"), params,
                                  prompts, kern[run], refs[run],
                                  decode_kernel(run, heads=base.n_heads)))
    return launches, base, params, prompts, kern[(True, 0, "fma", 0)][1]


def serve_cfg(base, run, backend):
    """``base`` on a serve run (paged, kv_splits, rescale, sink_tokens) and
    backend: "kernel", or "plain", the kernels' plain version (the pipeline
    form, FMA or AMLA: ``torch_pipeline`` / ``torch_paged_pipeline``; the
    reference backends' parallel form has no AMLA)."""
    paged, splits, rescale, sink = run
    if backend == "plain":
        backend = "torch_paged_pipeline" if paged else "torch_pipeline"
    return dataclasses.replace(base, kv_paged=paged, kv_splits=splits, kv_rescale=rescale,
                               kv_sink_tokens=sink, decode_backend=backend,
                               use_kernels=backend == "kernel")


def planned_splits(run, capacity=640, batch=4, heads=H) -> int:
    """The split count a serve run's decode resolves to (the port's rule:
    kv_splits, else the sm90 design's rule where its design takes the call,
    else the H100 split profile's plan, else the heuristic) at the cache
    ``capacity`` (a 512-token prompt + 16: 640), ``batch`` and ``heads``."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode import ops
    paged, splits, rescale, _ = run
    if not splits and _sm90(run):
        splits = K.sm90_num_splits(batch, heads, capacity, PAGE, _lib.sm_count(0))
    return ops.resolve_num_splits(splits, capacity, PAGE, batch,
                                  "paged" if paged else "contiguous", rescale)


def _sm90(run) -> bool:
    """Whether a serve run's split calls take A's sm90 design (fp8 pools,
    q_len 1, the MLA widths)."""
    from repro_torch.kernels.mla_decode import kernel as K
    paged, _, rescale, _ = run
    return paged and K.decode_design(fmt="fp8_e4m3", rescale=rescale, q_rank=3, d_c=D_C,
                                     d_r=D_R, page=PAGE) == "sm90"


def serve_shape(prompts, gen_steps=16):
    """(cache capacity, batch) of ``serve.generate`` on ``prompts``."""
    from repro_torch.core.kvcache import page_aligned_capacity
    return page_aligned_capacity(prompts.shape[1] + gen_steps, PAGE), prompts.shape[0]


def decode_kernel(run, capacity=640, batch=4, heads=H) -> str:
    """The one attention launch of an MLA decode step on a serve run:
    Fused-Q-Quant runs in the decode kernel's prologue, the combine (C or
    #4) in its epilogue; one planned split is the single pass; a split call
    A's sm90 design takes is that design's."""
    paged, _, rescale, _ = run
    if planned_splits(run, capacity, batch, heads) == 1:
        name = "single_pass_decode"
    else:
        name = "splitkv_decode_sm90" if _sm90(run) else "splitkv_decode"
    return ("paged_" if paged else "") + name + ("_amla" if rescale == "amla" else "")


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def fused_gate(lbl, cfg, params, prompts, loop, plain, kernel, gen_steps=16,
               per_step=None, aux=None, need_bitwise=False) -> dict:
    """``serve.generate_fused`` on ``cfg`` against ``generate``'s kernel run
    ``loop`` and its plain-backend run ``plain`` (each (tokens, tok/s,
    logits)) on the same weights and prompts: finite logits; the step
    loop's tokens; every step's logits bitwise equal to the step loop's
    (else the largest difference is reported, and fails past the serve
    gate's 1e-2 of the largest logit); against the plain backend the serve
    gates (prefill tokens equal, first decode step within 1e-2); and
    ``kernel`` launched once per layer (``per_step`` of them, default every
    layer; ``kernel`` None: no launch at all) and decode step and nothing
    else (D, C and #4 stay folded), counted as the launches made eagerly
    (the first decode step) plus those recorded into the graph times its
    replays. The first step is held on the rows ``serve_runs`` compared
    (the fused tokens are the step loop's). ``aux``: the encoder families' aux embeddings; with
    ``need_bitwise`` logits that are not bitwise equal to the step loop's
    fail. A counted main path. Returns its launches."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    _lib.reset_launches()                       # a counted fused run starts here
    stats: dict = {}
    toks, tps, logits = serve.generate_fused(cfg, params, prompts, gen_steps, aux_embed=aux,
                                             return_logits=True, stats=stats)
    torch.cuda.synchronize()
    eager, captured = dict(_lib.LAUNCHES), dict(_lib.CAPTURED)   # ... and ends here
    replays = stats["replays"]
    launches = {k: eager.get(k, 0) + captured.get(k, 0) * replays for k in eager | captured}
    per_step = cfg.n_layers if per_step is None else per_step
    want = {kernel: per_step * (gen_steps - 1)} if kernel else {}
    if replays != gen_steps - 2 or captured != ({kernel: per_step} if kernel else {}) \
            or launches != want:
        raise AssertionError(f"fused {lbl}: launches {eager} + {captured} x {replays} replays "
                             f"!= {want}")
    l_toks, l_tps, l_logits = loop
    if not torch.isfinite(logits).all():
        raise AssertionError(f"fused {lbl}: non-finite logits")
    if not torch.equal(toks, l_toks):
        raise AssertionError(f"fused {lbl}: tokens differ from the step loop's")
    bitwise = torch.equal(logits, l_logits)
    rel = float((logits - l_logits).abs().max() / l_logits.abs().max())
    if rel > 1e-2 or (need_bitwise and not bitwise):
        raise AssertionError(f"fused {lbl}: logits rel diff {rel} from the step loop's")
    first = _first_step_err(logits, plain[2], plain[3], f"fused {lbl}")
    if not torch.equal(toks[:, 0], plain[0][:, 0]):
        raise AssertionError(f"fused {lbl}: other prefill tokens than the plain backend's")
    emit(phase="fused", run=lbl, layers=cfg.n_layers, batch=prompts.shape[0],
         prompt=prompts.shape[1], gen=gen_steps, tokens_equal_step_loop=True,
         logits_bitwise_step_loop=bitwise, max_logit_rel_diff_step_loop=rel,
         first_step_logits_rel_err_vs_plain=first,
         greedy_agreement_vs_plain=float((toks == plain[0]).float().mean()),
         tok_per_s=tps, step_loop_tok_per_s=l_tps, capture_s=stats["capture_s"],
         decode_s=stats["decode_s"], replays=replays, launches_eager=eager,
         launches_captured=captured, launches=launches)
    return launches


def serve_runs(base, params, prompts, runs):
    """``serve.generate`` (16 new tokens) on each run (paged, kv_splits,
    rescale, sink_tokens), kernel backend against the plain backend (the
    kernels' plain version, ``serve_cfg(..., "plain")``): finite logits,
    equal prefill tokens, the first decode step within 1e-2 of the largest
    logit (an MoE model's rows whose first step routes otherwise in the two
    runs set aside: ``_MoERouting``), one attention launch per layer and
    decode step, and each contiguous run's paged twin bit-identical. The
    kernel runs are the counted path. Returns (launches, the kernel runs'
    outputs, the plain runs' outputs and, last, the rows the first step
    compares)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve

    B = prompts.shape[0]
    refs, routes = {}, {}
    for run in runs:
        with _MoERouting(B, base.n_layers) as routes[run]:
            refs[run] = serve.generate(serve_cfg(base, run, "plain"), params, prompts, 16,
                                       return_logits=True)
    kern, run_launches, launches = {}, {}, {}
    for run in runs:
        torch.cuda.synchronize()
        _lib.reset_launches()                 # a counted serve run starts here
        with _CountDecodeSteps() as steps, _MoERouting(B, base.n_layers) as route:
            kern[run] = serve.generate(serve_cfg(base, run, "kernel"), params, prompts, 16,
                                       return_logits=True)
        torch.cuda.synchronize()
        got = run_launches[run] = dict(_lib.LAUNCHES)   # ... and ends here
        refs[run] += (route.same_first_step(routes[run]),)
        want = {decode_kernel(run, *serve_shape(prompts), base.n_heads):
                base.n_layers * steps.n}
        if got != want:
            raise AssertionError(f"serve {run}: launches {got} != {want} for {steps.n} decode "
                                 f"steps")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    for run in runs:
        toks, tps, logits = kern[run]
        r_toks, r_tps, r_logits, rows = refs[run]
        paged, splits, rescale, sink = run
        lbl = f"serve paged={paged} kv_splits={splits} rescale={rescale} sink={sink}"
        if not (torch.isfinite(logits).all() and torch.isfinite(r_logits).all()):
            raise AssertionError(f"{lbl}: non-finite logits")
        # first decode step: the prefill is identical and each layer's
        # attention agrees to ~1e-6 (phase 3), but the next layer re-quantizes
        # its query and its new latent to fp8, where a one-ulp difference moves
        # a code by a whole fp8 step; over 30 random-weight layers that grows
        # to a few 1e-3 of the largest logit (measured on mla-7b: 2.7e-3, H100
        # run; A's sm90 design 9.4e-3)
        first = _first_step_err(logits, r_logits, rows, lbl)
        if not torch.equal(toks[:, 0], r_toks[:, 0]):
            raise AssertionError(f"{lbl}: prefill tokens differ")
        emit(phase="serve", arch=base.name, layers=base.n_layers, batch=prompts.shape[0],
             prompt=prompts.shape[1], gen=16,
             layout="paged" if paged else "contiguous", kv_splits=splits, rescale=rescale,
             sink_tokens=sink, tok_per_s=tps, ref_tok_per_s=r_tps,
             first_step_rows_compared=int(rows.sum()), first_step_rows_routed_otherwise=int(
                 (~rows).sum()),
             greedy_agreement_vs_ref=float((toks == r_toks).float().mean()),
             first_step_logits_rel_err=first, launches=run_launches[run])
    from repro_torch.kernels.mla_decode import kernel as K
    shape = serve_shape(prompts) + (base.n_heads,)
    for paged, splits, rescale, sink in runs:   # the two layouts: bit-identical
        if paged or sink or (True, splits, rescale, 0) not in kern:
            continue
        twin = (True, splits, rescale, 0)
        routed = decode_kernel(twin, *shape)
        with K.forced_design("exact"):   # the exact design's bits, in both layouts
            plans = [planned_splits((p, splits, rescale, 0), *shape) for p in (False, True)]
            if plans[0] != plans[1]:     # the profile plans the two layouts apart
                emit(phase="serve", arch=base.name, check="contiguous vs paged",
                     kv_splits=splits, rescale=rescale,
                     skipped=f"planned splits {plans} (contiguous, paged)")
                continue
            b = kern[twin] if decode_kernel(twin, *shape) == routed else serve.generate(
                serve_cfg(base, twin, "kernel"), params, prompts, 16, return_logits=True)
        a = kern[(False, splits, rescale, 0)]
        diff = float((a[2] - b[2]).abs().max())
        if not torch.equal(a[0], b[0]) or diff:
            raise AssertionError(f"serve {base.name} kv_splits={splits} {rescale}: contiguous "
                                 f"and paged runs differ (max logit diff {diff})")
        emit(phase="serve", arch=base.name, check="contiguous vs paged", kv_splits=splits,
             rescale=rescale, identical_tokens=True, max_logit_diff=diff,
             paged_rerun_on_exact=b is not kern[twin])
    return launches, kern, refs


def _first_step_err(logits, r_logits, rows, lbl) -> float:
    """The first decode step's largest logit difference over the largest
    logit, on ``rows``; raises past 1e-2 or with no row to compare."""
    if not bool(rows.any()):
        raise AssertionError(f"{lbl}: every row's first step routes otherwise than the plain "
                             "backend's")
    a, b = logits[rows, 1], r_logits[rows, 1]
    first = float((a - b).abs().max() / b.abs().max())
    if first > 1e-2:
        raise AssertionError(f"{lbl}: first-step logits rel err {first}")
    return first


class _MoERouting:
    """Records each MoE call of a ``generate`` run inside the block: the
    top-k experts of every token and which of its pairs the capacity rule
    kept. ``same_first_step(other)``: [B] rows whose first decode step (its
    ``layers`` MoE calls of ``batch`` tokens) routes alike in both runs; a
    router near-tie sends a token to other experts (or, through the
    capacity rule, drops another row's pair) and moves its whole logits
    row, which says nothing of the attention. All rows for a dense model."""

    def __init__(self, batch, layers):
        self.batch, self.layers, self.calls = batch, layers, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.route, self.dispatch = moe, moe._route, moe._dispatch

        def routed(params, cfg, xt):
            weights, ids = self.route(params, cfg, xt)
            self.calls.append([ids.clone()])
            return weights, ids

        def dispatched(xt, ids, E, C, k):
            out = self.dispatch(xt, ids, E, C, k)
            keep = torch.empty_like(out[2])
            keep[out[3]] = out[2]
            self.calls[-1].append(keep.reshape(ids.shape))
            return out
        moe._route, moe._dispatch = routed, dispatched
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._dispatch = self.route, self.dispatch

    def same_first_step(self, other):
        import torch
        first = [[c for c in r.calls if c[0].shape[0] == self.batch][:self.layers]
                 for r in (self, other)]
        same = torch.ones(self.batch, dtype=torch.bool, device="cuda")
        for (ids, keep), (ids_o, keep_o) in zip(*first):
            same &= ((ids == ids_o) & (keep == keep_o)).all(-1)
        return same


class _RecordResolves:
    """Records the backend each MLA decode resolves to inside the block."""

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.T, self.orig, self.names = T, T._resolve_backend, []

        def recorded(*a, **kw):
            backend = self.orig(*a, **kw)
            self.names.append(backend.name)
            return backend
        T._resolve_backend = recorded
        return self

    def __exit__(self, *exc):
        self.T._resolve_backend = self.orig


# phase 4b: the kv_splits of the shard-map runs (contiguous cache, FMA)
SHARD_MAP_SPLITS = (0, 4)


def phase_shard_map(base, params, prompts, smi):
    """``serve.generate`` (16 new tokens) on ``base`` with the shard_map
    backend over a (1, 1) mesh (an NCCL world of one, started here by
    ``make_host_mesh`` and destroyed at the end) against the ``ref`` backend
    (``torch_ref``, no mesh) on the same weights and prompts, contiguous
    cache, each of ``SHARD_MAP_SPLITS``: equal tokens, every step's logits
    bitwise equal, every MLA decode resolved to ``shard_map`` (none falls
    back), no kernel launched; at the first split count ``generate_fused``
    bitwise equal to the step loop; ``CommDebugMode`` counts 0 collectives
    over one decode step; tok/s and one decode step's host wall and device
    ms (``_profile``) for both backends. Not a counted path: the region runs
    the parallel form, no hand-written kernel."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    t_phase = time.time()
    if dist.is_initialized():
        raise AssertionError("shard-map phase: a process group exists already")
    mesh = make_host_mesh(1, "cuda")
    backend = str(dist.get_backend())
    if backend != "nccl" or tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"shard-map phase: mesh {tuple(mesh.shape)} on {backend}")
    B, S = prompts.shape
    for splits in SHARD_MAP_SPLITS:
        cfgs = {name: dataclasses.replace(base, kv_paged=False, kv_splits=splits,
                                          kv_rescale="fma", kv_sink_tokens=0,
                                          decode_backend=name, use_kernels=False)
                for name in ("shard-map", "ref")}
        T.SHARD_CTX = None
        t_gen = time.time()
        ref = serve.generate(cfgs["ref"], params, prompts, 16, return_logits=True)
        T.SHARD_CTX = {"mesh": mesh, "dp": "data", "use_shard_map": True}
        torch.cuda.synchronize()
        _lib.reset_launches()
        with _CountDecodeSteps() as steps, _RecordResolves() as resolves:
            got = serve.generate(cfgs["shard-map"], params, prompts, 16, return_logits=True)
        torch.cuda.synchronize()
        lbl = f"shard-map kv_splits={splits}"
        want = ["shard_map"] * (base.n_layers * steps.n)
        if resolves.names != want:
            other = sorted(set(resolves.names) - {"shard_map"})
            raise AssertionError(f"{lbl}: {len(resolves.names)} resolves, not {len(want)} "
                                 f"shard_map ones (others: {other})")
        if _lib.LAUNCHES:
            raise AssertionError(f"{lbl}: kernels launched {dict(_lib.LAUNCHES)}")
        if not torch.isfinite(got[2]).all():
            raise AssertionError(f"{lbl}: non-finite logits")
        if not torch.equal(got[0], ref[0]):
            raise AssertionError(f"{lbl}: tokens differ from the ref backend's")
        diff = float((got[2] - ref[2]).abs().max())
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"{lbl}: logits differ from the ref backend's by {diff}")
        fused = {}
        if splits == SHARD_MAP_SPLITS[0]:
            # the same run through generate_fused: the region captured in the
            # step's CUDA graph and replayed, bitwise equal to the step loop
            stats: dict = {}
            f_toks, f_tps, f_logits = serve.generate_fused(cfgs["shard-map"], params, prompts,
                                                           16, return_logits=True, stats=stats)
            torch.cuda.synchronize()
            if not (torch.equal(f_toks, got[0]) and torch.equal(f_logits, got[2])):
                raise AssertionError(f"{lbl}: generate_fused differs from the step loop")
            if stats["replays"] != 14 or _lib.LAUNCHES or _lib.CAPTURED:
                raise AssertionError(f"{lbl}: fused replays {stats['replays']}, launches "
                                     f"{dict(_lib.LAUNCHES)} + {dict(_lib.CAPTURED)}")
            fused = dict(fused_tokens_logits_bitwise=True, fused_tok_per_s=f_tps,
                         fused_replays=stats["replays"], fused_capture_s=stats["capture_s"])
        t_gen = time.time() - t_gen
        # one decode step after the prompt: its collectives, then its times
        t_prof = time.time()
        state = T.init_decode_state(cfgs["shard-map"], B, S + 64, device="cuda")
        logits, state = T.prefill(params, cfgs["shard-map"], prompts, state)
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        with CommDebugMode() as comm:
            T.decode_step(params, cfgs["shard-map"], tok, state, pos)
            torch.cuda.synchronize()
        if comm.get_total_counts():
            raise AssertionError(f"{lbl}: {comm.get_comm_counts()} collectives in one step")
        prof = {"shard-map": _profile(lambda: T.decode_step(params, cfgs["shard-map"], tok,
                                                            state, pos), reps=1)}
        T.SHARD_CTX = None
        prof["ref"] = _profile(lambda: T.decode_step(params, cfgs["ref"], tok, state, pos),
                               reps=1)
        t_prof = time.time() - t_prof
        emit(phase="shard_map", arch=base.name, layers=base.n_layers, batch=B, prompt=S,
             gen=16, layout="contiguous", kv_splits=splits, mesh=list(mesh.shape),
             process_group=backend, world_size=dist.get_world_size(), gpu=smi,
             tokens_equal_ref=True, logits_bitwise_ref=True, max_logit_diff=diff,
             resolves=len(resolves.names), decode_steps=steps.n, collectives_one_step=0,
             tok_per_s=got[1], ref_tok_per_s=ref[1],
             wall_ms_per_step=prof["shard-map"]["wall_ms_per_step"],
             device_ms_per_step=prof["shard-map"]["device_ms_per_step"],
             ref_wall_ms_per_step=prof["ref"]["wall_ms_per_step"],
             ref_device_ms_per_step=prof["ref"]["device_ms_per_step"],
             aten_ops_per_step=prof["shard-map"]["aten_ops_per_step"],
             ref_aten_ops_per_step=prof["ref"]["aten_ops_per_step"],
             generate_seconds=t_gen, profile_seconds=t_prof, **fused)
        del state
    dist.destroy_process_group()
    emit(phase="shard_map_done", seconds=time.time() - t_phase)


PROFILE_RUNS = ((True, 0, "fma"), (True, 4, "fma"), (True, 4, "amla"), (False, 0, "fma"))


def phase_profile(base, params, prompts, runs=PROFILE_RUNS, match=None, aux=None, **extra):
    """Where one decode step's time goes (kernel backend, context
    ``prompts``' length) on each run (paged, kv_splits, rescale), in the step
    loop and in the fused loop, on one state: ``steps.DecodeGraph.step`` run
    eagerly (the step loop's step: decode, pick, bookkeeping), then captured
    as a CUDA graph and replayed (``fused``). Each: host wall per step,
    device ms per step under torch.profiler (which lists each kernel node of
    a replayed graph), the device's idle share, aten ops per step, the
    heaviest kernels (``match``: also the device ms of the kernels whose name
    holds it); the capture's host seconds and the replays' ms on CUDA events
    (``aux``: the encoder families' aux embeddings; ``extra``: more fields
    for the line)."""
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    B, S = prompts.shape
    for paged, splits, rescale in runs:
        cfg = dataclasses.replace(base, kv_paged=paged, kv_splits=splits, kv_rescale=rescale,
                                  decode_backend="kernel", use_kernels=True)
        state = T.init_decode_state(cfg, B, S + 64, device="cuda")
        logits, state = T.prefill(params, cfg, prompts, state, aux)
        loop = ST.DecodeGraph(cfg, params, logits.argmax(-1).to(torch.int32), state,
                              torch.full((B,), S, dtype=torch.int32, device="cuda"))
        eager = _profile(loop.step, match=match)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        loop.capture(side)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        fused = _profile(loop.replay, match=match)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            loop.replay()
        end.record()
        torch.cuda.synchronize()
        if not bool(loop.ok):
            raise AssertionError(f"profile {base.name} {paged, splits, rescale}: non-finite "
                                 "logits")
        emit(phase="profile", step="decode", arch=base.name, layers=base.n_layers, batch=B,
             context=S, layout="paged" if paged else "contiguous", kv_splits=splits,
             rescale=rescale, **eager, fused=fused, capture_s=capture_s,
             replay_event_ms=start.elapsed_time(end) / 5, **extra)
        del loop, state


def engine_kit(base, params):
    """What the engine runs of a pure-MLA model share: the recording engine,
    ``run`` (one workload from serve's engine flags), ``served`` (the same
    through ``serve.run_engine``, restartable runs too), ``restartable``
    (``run``'s workload through serve's restartable loop), ``gate`` (no fault, no
    leaked page, every request done, the launches one per layer of each
    kernel a dispatch runs, added into ``launches``) and ``held_to_plain``
    (the plain backend forced onto a kernel run's tokens). The counted main
    path of each kernel-backend run is its ``ServingEngine.run`` alone: not
    the engine's warm-up, not a ``generate`` oracle, and not the
    plain-backend runs the kernel runs are held against."""
    import collections
    import types
    import torch
    from repro_torch.core.kvcache import page_aligned_capacity
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.scheduler import Request

    class Recording(ServingEngine):
        """Keeps the logits row behind each emitted token: (rid, index) ->
        row (a speculative row recomputed at a later step replaces the
        earlier one, so the kept row is the one whose token was committed).
        Counts the decode, verify, chunk and prefill dispatches and the kernel
        launches of ``run`` (also of a run a preemption ends). With ``forced``
        (rid -> tokens) it emits those tokens in place of its own greedy
        picks, which it keeps in ``own``: a plain-backend run forced onto a
        kernel run's tokens sees the same history at every row, so every row
        of the two runs can be compared. Every instance is kept in
        ``instances``; it times its snapshots (seconds, bytes on disk), its
        restore and its quant-health samples, and notes the step of each
        host-tier offload."""

        instances: list = []

        def __init__(self, *a, forced=None, **kw):
            self.step_logits, self.own, self.forced = {}, {}, forced
            self.snapshots, self.restored, self.probe_ms, self.offload_steps = [], None, [], []
            self.launches = {}
            super().__init__(*a, **kw)
            Recording.instances.append(self)
            self.dispatches = collections.Counter()
            for attr, kind in (("_decode_fn", "decode"), ("_verify_fn", "verify"),
                               ("_chunk_fn", "chunk"), ("_prefill_fn", "prefill")):
                fn = getattr(self, attr)
                if fn is not None:
                    setattr(self, attr, self._counting(fn, kind))
            if self.quant_probe is not None:
                self.quant_probe.sample = self._timed_probe(self.quant_probe.sample)

        def _counting(self, fn, kind):
            def call(*args):
                self.dispatches[kind] += 1
                return fn(*args)
            return call

        def _timed_probe(self, sample):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = sample(*args, **kw)
                torch.cuda.synchronize()
                self.probe_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        def run(self, requests, **kw):
            torch.cuda.synchronize()
            _lib.reset_launches()              # a counted main path starts here
            try:
                return super().run(requests, **kw)
            finally:
                torch.cuda.synchronize()
                self.launches = dict(_lib.LAUNCHES)   # ... and ends here

        def _drain_tier_ops(self):
            if any(kind == "offload" for kind, _, _ in self.allocator._pending):
                self.offload_steps.append(self.step_idx)
            super()._drain_tier_ops()

        def snapshot(self, directory, **kw):
            t0 = time.perf_counter()
            path = super().snapshot(directory, **kw)
            size = sum(f.stat().st_size for f in Path(path).iterdir())
            self.snapshots.append(dict(step=self.step_idx, seconds=time.perf_counter() - t0,
                                       bytes=size, tier_slots=self.tier.num_used
                                       if self.tier is not None else 0))
            return path

        def restore(self, path):
            t0 = time.perf_counter()
            super().restore(path)
            torch.cuda.synchronize()
            self.restored = dict(step=self.step_idx, seconds=time.perf_counter() - t0)

        def _postprocess(self, rows, reqs, counts=None):
            cs = counts if counts is not None else [len(r.out_tokens) for r in reqs]
            toks, finite = super()._postprocess(rows, reqs, counts)
            for i, (r, c) in enumerate(zip(reqs, cs)):
                self.step_logits[(r.rid, c)] = rows[i].float().clone()
                self.own[(r.rid, c)] = int(toks[i])
                if self.forced is not None and c < len(self.forced[r.rid]):
                    toks[i] = self.forced[r.rid][c]
            return toks, finite

    kcfg = dataclasses.replace(base, decode_backend="kernel", use_kernels=True)
    pcfg = dataclasses.replace(base, decode_backend="torch_paged_pipeline", use_kernels=False)
    launches: dict = {}

    def parse(flags, **over):
        args = serve.build_parser().parse_args(["--engine", *flags])
        for k, v in over.items():
            setattr(args, k, v)
        return args

    def setup(cfg, args):
        prompts = serve._engine_prompts(cfg, args)
        span = page_aligned_capacity(max(len(x) for x in prompts) + args.gen,
                                     cfg.page_size) // cfg.page_size
        ecfg = EngineConfig(max_batch=args.max_batch or len(prompts), max_pages_per_seq=span,
                            n_pages=args.pool_pages, prefix_cache_pages=args.prefix_cache_pages,
                            host_tier_pages=args.host_tier_pages,
                            prefill_budget=args.prefill_budget, spec_draft_len=args.spec_draft)
        reqs = lambda: [Request(rid=i, prompt=x, max_new=args.gen,  # noqa: E731
                                arrival=float(i * args.arrival_gap))
                        for i, x in enumerate(prompts)]
        return dataclasses.replace(cfg, prefill_chunk=args.prefill_chunk), ecfg, reqs, prompts

    def run(cfg, args, forced=None):
        cfg, ecfg, reqs, prompts = setup(cfg, args)
        eng = Recording(cfg, params, ecfg, device="cuda", forced=forced)
        t0 = time.time()
        res = eng.run(reqs())
        return eng, {r.rid: r for r in res}, time.time() - t0, prompts

    def served(flags):
        """``serve.run_engine`` (its gates and exact oracle) on the kernel
        backend with ``Recording`` as its engine: ``run_engine``'s output,
        the engine of every attempt (one per restart) and the wall
        seconds."""
        import repro_torch.serving.engine as engine_mod
        Recording.instances.clear()
        engine_mod.ServingEngine = Recording
        t0 = time.time()
        try:
            out = serve.run_engine(kcfg, params, parse(flags, backend="kernel"))
        finally:
            engine_mod.ServingEngine = ServingEngine
        engines = list(Recording.instances)
        Recording.instances.clear()             # the engines hold the model's weights
        return out, engines, time.time() - t0

    def restartable(cfg, args, ckpt_dir):
        """``run``'s workload through ``serve.run_restartable`` (``serve
        --restartable``'s loop) on the recording engine, without
        ``run_engine``'s ``generate`` oracle: chunked prefill and a reused
        prefix read earlier pages from the FP8 pool, so near-ties can pick
        other tokens than ``generate``'s (E2's oracle agreement). The engine
        of every attempt, the results and the wall seconds."""
        from repro_torch.serving.faults import FaultPlan
        cfg, ecfg, reqs, _ = setup(cfg, args)
        plan = FaultPlan.parse(args.inject)
        engines = []

        def new_engine(handler):
            engines.append(Recording(cfg, params, ecfg, device="cuda", fault_plan=plan,
                                     preemption=handler))
            return engines[-1]

        t0 = time.time()
        _, res = serve.run_restartable(new_engine, reqs(), args, ckpt_dir)
        return engines, {r.rid: r for r in res}, time.time() - t0

    def expected_launches(eng, amla=False):
        """One launch per layer of each kernel a dispatch runs: a decode step
        runs the decode kernel its planned split count takes (the single pass
        at one split) with Fused-Q-Quant in its prologue, a verify step the q_len > 1 split-KV
        kernel with Fused-Q-Quant in its prologue and the combine (C, or #4
        under AMLA) in its epilogue, a chunk step the fused fetch-dequant."""
        L, d = base.n_layers, eng.dispatches
        sfx = "_amla" if amla else ""
        if eng.page != PAGE:
            raise AssertionError(f"engine page {eng.page} != {PAGE}")
        decode = decode_kernel((True, eng.cfg.kv_splits, "amla" if amla else "fma", 0),
                               eng.span_pages * eng.page, eng.ecfg.max_batch, base.n_heads)
        want = {decode: L * d["decode"],
                "paged_splitkv_decode_verify" + sfx: L * d["verify"],
                "paged_fetch_dequant": L * d["chunk"]}
        return {k: v for k, v in want.items() if v}

    def gate(lbl, eng, res, amla=False, attempts=None):
        """``attempts``: every engine of a restartable run (``eng`` its last),
        whose launches and dispatches are summed."""
        m = eng.metrics()
        f = m["faults"]
        bad = {k: f[k] for k in ("backend_faults", "ref_fallback_steps", "nonfinite_rows")
               if f[k]}
        if bad:
            raise AssertionError(f"{lbl}: fault counters {bad}")
        if m["pages"]["free"] + m["pages"]["cached"] != m["pages"]["capacity"]:
            raise AssertionError(f"{lbl}: pages leaked after the drain")
        if any(r.status != "done" for r in res.values()):
            raise AssertionError(f"{lbl}: requests not done: "
                                 f"{[(r.rid, r.status) for r in res.values()]}")
        got, want = {}, {}
        for e in attempts or [eng]:
            _add(got, e.launches)
            _add(want, expected_launches(e, amla))
        if got != want:
            raise AssertionError(f"{lbl}: launches {got} != {want} for dispatches "
                                 f"{[dict(e.dispatches) for e in attempts or [eng]]}")
        _add(launches, got)
        return m

    def tokens(res):
        return {rid: r.tokens for rid, r in res.items()}

    def oracle(cfg, prompts, gen):
        """``generate``'s tokens and logits per request, one static batch
        per prompt length (``run_engine``'s grouping)."""
        import numpy as np
        out = {}
        for n in sorted({len(x) for x in prompts}):
            rids = [i for i, x in enumerate(prompts) if len(x) == n]
            batch = torch.from_numpy(np.stack([prompts[i] for i in rids]))
            toks, _, logits = serve.generate(cfg, params, batch.long().cuda(), gen,
                                             return_logits=True)
            for j, rid in enumerate(rids):
                out[rid] = (toks[j].tolist(), logits[j])
        return out

    def held_to_plain(lbl, a, a_res, cfg, args):
        """The plain backend run forced onto the kernel run's tokens: every
        logits row within 1e-2 of its largest logit of the kernel run's row
        (PR 12's serve gate), and where the plain run's own greedy pick
        differs, both picks within that difference of each other in both
        runs (a near-tie). Returns the plain engine, its wall seconds, the
        largest relative row difference and the near-tie flips."""
        b, b_res, wall, _ = run(cfg, args, forced=tokens(a_res))
        if tokens(b_res) != tokens(a_res):
            raise AssertionError(f"{lbl}: forced run emitted other tokens")
        if set(b.step_logits) != set(a.step_logits):
            raise AssertionError(f"{lbl}: the two runs computed different rows")
        worst, flips = 0.0, []
        for key in sorted(a.step_logits):
            la, lb = a.step_logits[key], b.step_logits[key]
            top = float(lb.abs().max())
            diff = float((la - lb).abs().max()) / top
            worst = max(worst, diff)
            if diff > 1e-2:
                raise AssertionError(f"{lbl}: logits row {key} rel err {diff} > 1e-2")
            ta, tb = a.own[key], b.own[key]
            if ta != tb:
                flip = dict(rid=key[0], index=key[1], tokens=[ta, tb], rel_logit_diff=diff,
                            rel_margin_a=float(la[ta] - la[tb]) / top,
                            rel_margin_b=float(lb[tb] - lb[ta]) / top)
                flips.append(flip)
                if not (flip["rel_margin_a"] <= diff and flip["rel_margin_b"] <= diff):
                    raise AssertionError(f"{lbl}: greedy picks differ at {key}, not at a "
                                         f"near-tie: {flip}")
        return b, wall, worst, flips

    return types.SimpleNamespace(
        kcfg=kcfg, pcfg=pcfg, launches=launches, parse=parse, run=run, served=served,
        restartable=restartable, gate=gate, tokens=tokens, held_to_plain=held_to_plain, oracle=oracle)


def phase_engine(base, params, serve_tps):
    """E1-E3 on full mla-7b, kernel backend, over the shared paged pool
    (``engine_kit`` says what each run is held to and what it counts)."""
    from repro_torch.launch import steps as ST
    kit = engine_kit(base, params)
    kcfg, pcfg = kit.kcfg, kit.pcfg
    parse, run, gate, tokens, held_to_plain = (kit.parse, kit.run, kit.gate, kit.tokens,
                                               kit.held_to_plain)

    # E1: monolithic admission, staggered arrivals, shared prefix, through
    # run_engine and its exact greedy oracle gate; run_engine builds the
    # recording engine, so only its run() is counted
    out1, _, w1 = kit.served(E1)
    e1 = out1["engine"]
    m1 = gate("E1", e1, {r.rid: r for r in out1["results"]})
    if m1["pages"]["saved_by_sharing"] <= 0:
        raise AssertionError("E1: no page saved by prefix sharing")
    emit(phase="engine", run="E1", flags=E1, seconds=w1, steps=m1["steps"],
         tok_per_s=m1["wall"]["decode_tok_per_s"], saved_by_sharing=m1["pages"]["saved_by_sharing"],
         peak_pages=m1["pages"]["peak_in_use"], oracle="exact",
         dispatches=dict(e1.dispatches), launches=e1.launches)

    # E2: chunked prefill (budget 512), against the plain backend; the
    # reference's oracle reported, not gated
    a2 = parse(E2)
    e2, r2, w2, prompts2 = run(kcfg, a2)
    m2 = gate("E2", e2, r2)
    if not e2.dispatches["chunk"]:
        raise AssertionError("E2: no chunked prefill dispatch")
    n_buckets = len(ST.chunk_buckets(a2.prefill_chunk))
    if m2["prefill"]["traces"] > n_buckets:
        raise AssertionError(f"E2: {m2['prefill']['traces']} chunk widths > {n_buckets}")
    p2, pw2, worst2, flips2 = held_to_plain("E2 kernel vs plain backend", e2, r2, pcfg, a2)
    first = max(float((e2.step_logits[(i, 0)] - p2.step_logits[(i, 0)]).abs().max()
                      / p2.step_logits[(i, 0)].abs().max()) for i in r2)
    agree, diverge = oracle_agreement(kit.oracle(kcfg, prompts2, a2.gen), r2, prompts2)
    emit(phase="engine", run="E2", flags=E2, seconds=w2, plain_seconds=pw2, steps=m2["steps"],
         tok_per_s=m2["wall"]["decode_tok_per_s"], plain_tok_per_s=p2.metrics()["wall"][
             "decode_tok_per_s"], chunk_widths=m2["prefill"]["traces"], buckets=n_buckets,
         prefill_tokens_series=m2["prefill"]["tokens_series"],
         stall_tokens_total=m2["work"]["stall_tokens_total"],
         fetch_pages_bounded=m2["fetch_work"]["pages_fetched_bounded"],
         rows_vs_plain=len(e2.step_logits), max_row_rel_err_vs_plain=worst2,
         near_tie_flips_vs_plain=flips2, first_token_logits_rel_err=first,
         oracle_agreement=agree, oracle_divergence=diverge,
         dispatches=dict(e2.dispatches), launches=e2.launches)

    # E3: speculative decoding (q_len = 5 verify every step) against the
    # non-speculative engine (exactly) and the plain backend; then its AMLA
    # mode
    a3 = parse(E3)
    e3, r3, w3, _ = run(kcfg, a3)
    m3 = gate("E3", e3, r3)
    if not e3.dispatches["verify"]:
        raise AssertionError("E3: no verify dispatch")
    a3n = parse(E3, spec_draft=0)
    e3n, r3n, w3n, _ = run(kcfg, a3n)
    m3n = gate("E3 non-speculative", e3n, r3n)
    if tokens(r3) != tokens(r3n):
        rid = next(i for i in sorted(r3) if r3[i].tokens != r3n[i].tokens)
        raise AssertionError(f"E3: speculative tokens differ from sequential for request "
                             f"{rid}: {r3[rid].tokens} vs {r3n[rid].tokens}")
    p3, pw3, worst3, flips3 = held_to_plain("E3 kernel vs plain backend", e3, r3, pcfg, a3)
    sp = m3["speculative"]
    emit(phase="engine", run="E3", flags=E3, seconds=w3, steps=m3["steps"],
         tok_per_s=m3["wall"]["decode_tok_per_s"], verify_steps=sp["verify_steps"],
         drafted=sp["drafted_tokens"], accepted=sp["accepted_tokens"],
         accepted_tokens_per_step=sp["accepted_tokens_per_step"],
         non_spec_steps=m3n["steps"], non_spec_tok_per_s=m3n["wall"]["decode_tok_per_s"],
         non_spec_seconds=w3n, plain_spec_seconds=pw3,
         generate_tok_per_s_serve_phase=serve_tps, tokens_equal_non_speculative=True,
         rows_vs_plain=len(e3.step_logits), max_row_rel_err_vs_plain=worst3,
         near_tie_flips_vs_plain=flips3, dispatches=dict(e3.dispatches),
         launches=e3.launches, non_spec_dispatches=dict(e3n.dispatches),
         non_spec_launches=e3n.launches)
    # E3's AMLA mode, held to the same two checks as FMA: the non-speculative
    # AMLA engine (exactly) and the plain AMLA backend forced onto its tokens;
    # its agreement with the FMA run is reported only (AMLA and FMA differ
    # by ~2% of tokens under FP8, tests/test_parity.py:168-186)
    acfg = dataclasses.replace(kcfg, kv_rescale="amla")
    e3a, r3a, w3a, _ = run(acfg, a3)
    m3a = gate("E3 amla", e3a, r3a, amla=True)
    e3an, r3an, w3an, _ = run(acfg, a3n)
    m3an = gate("E3 amla non-speculative", e3an, r3an, amla=True)
    if tokens(r3a) != tokens(r3an):
        rid = next(i for i in sorted(r3a) if r3a[i].tokens != r3an[i].tokens)
        raise AssertionError(f"E3 amla: speculative tokens differ from sequential for request "
                             f"{rid}: {r3a[rid].tokens} vs {r3an[rid].tokens}")
    p3a, pw3a, worst3a, flips3a = held_to_plain(
        "E3 amla kernel vs plain backend", e3a, r3a,
        dataclasses.replace(pcfg, kv_rescale="amla"), a3)
    emit(phase="engine", run="E3 amla", seconds=w3a, steps=m3a["steps"],
         tok_per_s=m3a["wall"]["decode_tok_per_s"],
         drafted=m3a["speculative"]["drafted_tokens"],
         accepted=m3a["speculative"]["accepted_tokens"],
         non_spec_steps=m3an["steps"], non_spec_seconds=w3an, plain_spec_seconds=pw3a,
         tokens_equal_non_speculative=True, rows_vs_plain=len(e3a.step_logits),
         max_row_rel_err_vs_plain=worst3a, near_tie_flips_vs_plain=flips3a,
         token_agreement_vs_fma=sum(a == b for i in r3 for a, b in
                                    zip(r3[i].tokens, r3a[i].tokens)) / sum(
             len(r.tokens) for r in r3.values()),
         dispatches=dict(e3a.dispatches), launches=e3a.launches,
         non_spec_dispatches=dict(e3an.dispatches), non_spec_launches=e3an.launches)
    return kit, {r.rid: r.tokens for r in out1["results"]}


def tier_copies(eng, reps=6):
    """The host tier's page moves on E4's pool through the engine's own
    hooks (``_gather_page``: the layers' page stacked on the compute stream,
    then ``HostTier.store``; ``HostTier.prefetch``, then ``take`` and
    ``_write_page``), timed with CUDA events on the tier's side stream over
    ``reps`` pages after one untimed round that fills the pinned-memory
    cache: offload and upload microseconds per page, beside the page's bytes
    over the pinned copy rates measured here (one 32-page copy each way),
    and the host wall of each. The restored pages are checked byte for
    byte."""
    import torch
    from repro_torch.core.kvcache import pool_read_page
    from repro_torch.serving.tiering import HostTier
    pools = eng.state["layers"]
    n_pages = pools[0].content.shape[0]
    pids = [1 + i % (n_pages - 1) for i in range(reps)]
    page_bytes = sum(t.nbytes for p in pools for t in pool_read_page(p, 0))
    tier = HostTier(reps, device="cuda")

    def offload():
        slots = [tier.alloc_slot() for _ in pids]
        for slot, pid in zip(slots, pids):
            tier.store(slot, eng._gather_page(pid))
        return slots

    for slot in offload():                      # untimed: fills the pinned cache
        tier.drop(slot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pid in pids:                            # the stack alone, on the compute stream
        eng._gather_page(pid)
    torch.cuda.synchronize()
    gather_wall = time.perf_counter() - t0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    ev[0].record(tier.stream)
    slots = offload()
    ev[1].record(tier.stream)
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    want = [[t.clone() for p in pools for t in pool_read_page(p, pid)] for pid in pids]
    for p in pools:                             # the pages are free again: reused
        for pid in pids:
            p.content.view(torch.uint8)[pid].zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[2].record(tier.stream)
    for slot in slots:
        tier.prefetch(slot)
    ev[3].record(tier.stream)
    payloads = [tier.take(slot) for slot in slots]
    t1 = time.perf_counter()
    for pid, payload in zip(pids, payloads):
        eng._write_page(pid, payload)
    torch.cuda.synchronize()
    up_wall, write_wall = time.perf_counter() - t0, time.perf_counter() - t1
    for pid, w in zip(pids, want):
        got = [t for p in pools for t in pool_read_page(p, pid)]
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(got, w)):
            raise AssertionError("host tier: a restored page differs from the offloaded one")
    n = 32 * page_bytes
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        dst.copy_(src, non_blocking=True)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            dst.copy_(src, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        rates[name] = 3 * n / (a.elapsed_time(b) * 1e-3)
    off_us = ev[0].elapsed_time(ev[1]) * 1e3 / reps
    up_us = ev[2].elapsed_time(ev[3]) * 1e3 / reps
    return dict(page_bytes=page_bytes, host_copies_per_page=3, pages=reps,
                offload_us_per_page=off_us, upload_us_per_page=up_us,
                offload_host_wall_us_per_page=off_wall * 1e6 / reps,
                restore_host_wall_us_per_page=up_wall * 1e6 / reps,
                gather_host_wall_us_per_page=gather_wall * 1e6 / reps,
                write_host_wall_us_per_page=write_wall * 1e6 / reps,
                pinned_d2h_bytes_per_s=rates["d2h"], pinned_h2d_bytes_per_s=rates["h2d"],
                offload_bound_us=page_bytes / rates["d2h"] * 1e6,
                upload_bound_us=page_bytes / rates["h2d"] * 1e6)


def phase_engine_state(kit, params, e1_tokens):
    """E4, E4 restartable and E5 on full mla-7b, kernel backend, over the
    shared paged pool: the engine's state off the card (the host tier,
    snapshot / restore after a preemption, the span tracer, the quant-health
    probe), each run held to the launch rule of E1-E3 (``engine_kit``)."""
    import tempfile
    from repro_torch.obs.trace import validate_chrome_trace
    kcfg, parse, run, gate, tokens = kit.kcfg, kit.parse, kit.run, kit.gate, kit.tokens

    # E4: the cold run, then the cache of 1 page and the host tier of 8
    e4c, r4c, w4c, _ = run(kcfg, parse(E4))
    gate("E4 cold", e4c, r4c)
    e4, r4, w4, _ = run(kcfg, parse(E4 + E4_TIER))
    m4 = gate("E4", e4, r4)
    pc = m4["prefix_cache"]
    if tokens(r4) != tokens(r4c):
        raise AssertionError(f"E4: tiered tokens differ from the cold run's: {tokens(r4)} vs "
                             f"{tokens(r4c)}")
    if pc["offloads"] < 1 or pc["restored_host"] < 1:
        raise AssertionError(f"E4: no host-tier round trip: {pc}")
    emit(phase="engine", run="E4", flags=E4 + E4_TIER, seconds=w4, cold_seconds=w4c,
         steps=m4["steps"], cold_steps=e4c.metrics()["steps"], prefix_cache=pc,
         prefill_tokens=m4["prefill"]["tokens"],
         cold_prefill_tokens=e4c.metrics()["prefill"]["tokens"],
         offload_steps=e4.offload_steps, tokens_equal_cold=True,
         dispatches=dict(e4.dispatches), launches=e4.launches,
         tier_copies=tier_copies(e4))

    # E4 restartable, through serve's restartable loop: preempted two steps
    # after the first offload, so the snapshot carries a populated tier
    preempt_at = e4.offload_steps[0] + 2
    flags = E4 + E4_TIER + ["--restartable", "--ckpt-every", "2", "--inject",
                            f"preempt:{preempt_at}"]
    with tempfile.TemporaryDirectory() as d:
        engines, r4r, w4r = kit.restartable(kcfg, parse(flags), d)
    m4r = gate("E4 restartable", engines[-1], r4r, attempts=engines)
    f = m4r["faults"]
    if tokens(r4r) != tokens(r4c):
        raise AssertionError("E4 restartable: tokens differ from the cold run's")
    if len(engines) != 2 or f["preemptions"] != 1 or f["restores"] != 1:
        raise AssertionError(f"E4 restartable: {len(engines)} attempts, faults {f}")
    carried = engines[0].snapshots[-1]
    if not carried["tier_slots"]:
        raise AssertionError("E4 restartable: the preemption snapshot carried an empty tier")
    emit(phase="engine", run="E4 restartable", flags=flags, seconds=w4r,
         steps=m4r["steps"], preempted_at_step=preempt_at, snapshots=engines[0].snapshots,
         restore=engines[-1].restored, prefix_cache=m4r["prefix_cache"],
         tokens_equal_cold=True,
         dispatches=[dict(e.dispatches) for e in engines],
         launches=[e.launches for e in engines])

    # E5: E1 through serve.run_engine (its exact oracle gate) restartable,
    # traced and probed
    with tempfile.TemporaryDirectory() as d:
        trace = Path(d) / "trace.json"
        flags = E1 + E5_STATE + ["--ckpt-dir", f"{d}/ckpt", "--trace-out", str(trace)]
        out5, engines, w5 = kit.served(flags)
        payload = json.loads(trace.read_text())
    res5 = {r.rid: r for r in out5["results"]}
    m5 = gate("E5", engines[-1], res5, attempts=engines)
    f = m5["faults"]
    if tokens(res5) != e1_tokens:
        raise AssertionError("E5: restored tokens differ from E1's uninterrupted tokens")
    if len(engines) != 2 or f["preemptions"] != 1 or f["restores"] != 1:
        raise AssertionError(f"E5: {len(engines)} attempts, faults {f}")
    stats = validate_chrome_trace(payload, expect_requests=6)
    names = [e.get("name") for e in payload["traceEvents"]]
    if names.count("preemption") != 1:
        raise AssertionError("E5: the trace does not hold one preemption instant")
    samples = [s for e in engines for s in e.quant_probe.samples]
    live = [s for s in samples if s["resident_pages"] > 0]
    if not live or not all(0 < s["scale_min"] <= s["scale_max"] < float("inf") for s in live):
        raise AssertionError(f"E5: the probe saw no resident page with a finite scale range: "
                             f"{samples}")
    probe_ms = [ms for e in engines for ms in e.probe_ms]
    emit(phase="engine", run="E5", flags=flags, seconds=w5, steps=m5["steps"],
         tokens_equal_e1=True, oracle="exact", snapshots=engines[0].snapshots,
         restore=engines[-1].restored, trace=stats,
         trace_counts={k: sum(1 for e in payload["traceEvents"] if e.get("ph") == k)
                       for k in ("X", "i", "C", "M")},
         probe_samples=len(samples), probe_ms_per_sample=statistics.median(probe_ms),
         probe_ms=probe_ms, probe_last=samples[-1],
         dispatches=[dict(e.dispatches) for e in engines],
         launches=[e.launches for e in engines])
    return kit.launches


def oracle_agreement(oracle, res, prompts):
    """How many engine requests equal ``generate``'s tokens ("k/n"), and for
    each that does not, its first differing step with the oracle's top-2
    margin there."""
    import torch
    diverge = []
    for i in sorted(res):
        got_t, want_t = res[i].tokens, oracle[i][0]
        if got_t != want_t:
            step = next(k for k, (x, y) in enumerate(zip(got_t, want_t)) if x != y)
            top2 = torch.topk(oracle[i][1][step].float(), 2).values
            diverge.append(dict(rid=i, prompt_len=len(prompts[i]), step=step,
                                engine=got_t[step], oracle=want_t[step],
                                oracle_top2_margin=float(top2[0] - top2[1]),
                                oracle_max_logit=float(oracle[i][1][step].abs().max())))
    return f"{len(res) - len(diverge)}/{len(res)}", diverge


def _profile(fn, reps=3, match=None):
    """Host wall per call and the device time by kernel under torch.profiler
    (``match``: also the device ms per call of the kernels whose name holds it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = sorted(((r.key, r.self_device_time_total / (reps * 1e3), r.count / reps)
                  for r in rows if r.self_device_time_total > 0
                  and not r.key.startswith("aten::")), key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    out = dict(wall_ms_per_step=wall, device_ms_per_step=busy,
               device_idle_share=1.0 - busy / wall,
               aten_ops_per_step=sum(r.count for r in rows
                                     if r.key.startswith("aten::")) / reps,
               top=[(k[:80], round(ms, 4), n) for k, ms, n in dev[:8]])
    if match is not None:
        out["match"] = match
        out["match_ms_per_step"] = sum(ms for k, ms, _ in dev if match in k)
        out["match_calls_per_step"] = sum(n for k, _, n in dev if match in k)
    return out


def phase_profile_engine(gen, base, params, prompts):
    """One chunked-prefill step (B = 1, a 256-token chunk after 768 tokens:
    E2's last chunk; K1's device ms per step beside it) and one verify step
    (B = 4, q_len = 5 after 512 tokens: E3's shape), kernel backend."""
    import torch
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(base, kv_paged=True, decode_backend="kernel", use_kernels=True)
    state = T.init_decode_state(cfg, 1, 1024, device="cuda")
    toks = torch.randint(0, base.vocab_size, (1, 1024), generator=gen, device="cuda")
    _, state = T.prefill(params, cfg, toks[:, :768], state)
    chunk = toks[:, 768:]
    cs, last = (torch.tensor([768], dtype=torch.int32, device="cuda"),
                torch.tensor([255], dtype=torch.int32, device="cuda"))
    emit(phase="profile", step="chunked_prefill", batch=1, chunk=256, chunk_start=768,
         **_profile(lambda: T.chunked_prefill(params, cfg, chunk, state, cs, last),
                    match="fetch_dequant_kernel"))
    state = T.init_decode_state(cfg, 4, 640, device="cuda")
    _, state = T.prefill(params, cfg, prompts, state)
    toks = prompts[:, :5].to(torch.int32)
    start = torch.full((4,), 512, dtype=torch.int32, device="cuda")
    emit(phase="profile", step="verify", batch=4, q_len=5, context=512,
         **_profile(lambda: T.verify_step(params, cfg, toks, state, start)))


# phase 8: the dense GQA family (llama3.2-3b full, gemma3-27b's window)
GQA_LLAMA_LENS = [527, 512, 520, 513]          # positions 511-526, N = 640
GQA_LONG_LENS = [0, PAGE, 32768, 20000]
GQA_CASES = [  # #7's cases: (tag, fmt, lens, N, Hkv, g, dh, window, block)
    ("gqa_llama_serve", "fp8_e4m3", GQA_LLAMA_LENS, 640, 8, 3, 128, 0, PAGE),
    ("gqa_llama_serve_int8", "int8", GQA_LLAMA_LENS, 640, 8, 3, 128, 0, PAGE),
    ("gqa_llama_serve_none", "none", GQA_LLAMA_LENS, 640, 8, 3, 128, 0, PAGE),
    ("gqa_qwen_serve", "fp8_e4m3", GQA_LLAMA_LENS, 640, 2, 8, 128, 0, PAGE),
    ("gqa_gemma_ring", "fp8_e4m3", [1200, 300], 1024, 16, 2, 128, 1024, PAGE),
    ("gqa_mqa", "fp8_e4m3", [200, 37], 256, 1, 8, 64, 0, 64),
    ("gqa_mha", "int8", [256, 100], 256, 8, 1, 64, 96, 64),
    ("gqa_long_32k", "fp8_e4m3", GQA_LONG_LENS, 32768, 8, 3, 128, 0, PAGE),
    # granite-3-2b's heads: d_head 64, Hkv 8, g 4
    ("gqa_granite_serve", "fp8_e4m3", GQA_LLAMA_LENS, 640, 8, 4, 64, 0, PAGE),
    ("gqa_granite_long_32k", "fp8_e4m3", GQA_LONG_LENS, 32768, 8, 4, 64, 0, PAGE),
    # recurrentgemma-9b's swa layers: MQA (Hkv 1, g 16) at d_head 256, window
    # 2048; the serving shape (a 640-slot ring, the window not yet reached),
    # a wrapped 2,048-slot ring, and 32k rows (no window)
    ("gqa_rg_serve", "fp8_e4m3", GQA_LLAMA_LENS, 640, 1, 16, 256, 2048, PAGE),
    ("gqa_rg_serve_int8", "int8", GQA_LLAMA_LENS, 640, 1, 16, 256, 2048, PAGE),
    ("gqa_rg_serve_none", "none", GQA_LLAMA_LENS, 640, 1, 16, 256, 2048, PAGE),
    ("gqa_rg_ring", "fp8_e4m3", [3000, 2100, 700, 2048], 2048, 1, 16, 256, 2048, PAGE),
    ("gqa_rg_long_32k", "fp8_e4m3", GQA_LONG_LENS, 32768, 1, 16, 256, 0, PAGE),
    ("gqa_long_32k_none", "none", GQA_LONG_LENS, 32768, 8, 3, 128, 0, PAGE),
    # the static cross caches of the encoder families (batch 4, every row
    # filled, the query at CROSS_POS past every slot): whisper-base's MHA
    # (Hkv 8, g 1, d_head 64; 1,500 frames in 1,536 slots) and
    # llama-3.2-vision-90b's (Hkv 8, g 8, d_head 128; 6,404 patches in 6,528)
    *((f"gqa_cross_whisper{sfx}", fmt, [1500] * 4, 1500, 8, 1, 64, 0, PAGE)
      for fmt, sfx in (("fp8_e4m3", ""), ("int8", "_int8"), ("none", "_none"))),
    *((f"gqa_cross_vision{sfx}", fmt, [6404] * 4, 6404, 8, 8, 128, 0, PAGE)
      for fmt, sfx in (("fp8_e4m3", ""), ("int8", "_int8"), ("none", "_none")))]
GQA_SWEEP = ("gqa_llama_serve", "gqa_qwen_serve", "gqa_long_32k", "gqa_granite_serve",
             "gqa_granite_long_32k", "gqa_rg_serve", "gqa_rg_long_32k", "gqa_cross_whisper",
             "gqa_cross_vision")  # the width line
# #7's bf16 ('none') cases timed beside scaled_dot_product_attention (the
# library row): llama's serving shape, 32k, d_head 256, both cross shapes
GQA_LIBRARY = ("gqa_llama_serve_none", "gqa_long_32k_none", "gqa_rg_serve_none",
               "gqa_cross_whisper_none", "gqa_cross_vision_none")
CROSS_POS = 2**31 - 2     # transformer.CROSS_POS: a cross layer's query position
# the kernel rows timed beside one PyTorch call computing the same function:
# (the case whose library time the row's library_ms carries, all such cases)
LIBRARY_ROWS = {"gqa_decode": ("gqa_llama_serve_none", GQA_LIBRARY)}
GQA_SERVE = [  # (arch, layers kept (0 = all), batch, prompt, gen, formats)
    ("llama3.2-3b", 0, 4, 512, 16, ("fp8_e4m3", "none")),
    ("gemma3-27b", 6, 2, 1200, 16, ("fp8_e4m3",)),
    ("granite-3-2b", 0, 4, 512, 16, ("fp8_e4m3",)),
    # the MoE GQA models at full width, one superblock (one layer) each
    ("mixtral-8x7b", 1, 4, 512, 16, ("fp8_e4m3",)),
    ("qwen3-moe-30b-a3b", 1, 4, 512, 16, ("fp8_e4m3",)),
    # the recurrent families at full width and depth: recurrentgemma-9b (26
    # rglru layers, 12 swa layers through #7 at d_head 256), xlstm-1.3b (42
    # mlstm, 6 slstm; no kernel on its path)
    ("recurrentgemma-9b", 0, 4, 512, 16, ("fp8_e4m3",)),
    ("xlstm-1.3b", 0, 4, 512, 16, ("fp8_e4m3",))]
# phase 8b: the encoder families, whisper-base at full width and depth (6
# encoder + 6 'dec' layers) and llama-3.2-vision-90b at published widths cut
# to one superblock (4 'attn' + 1 'cross' of 100 layers: 6.38 B float32
# parameters, 25.5 GB; all 100 would be ~351 GB)
ENCODER_SERVE = [("whisper-base", 0, 4, 512, 16, ("fp8_e4m3",)),
                 ("llama-3.2-vision-90b", 5, 4, 512, 16, ("fp8_e4m3",))]
# the GQA_SERVE and ENCODER_SERVE models that also run through generate_fused
# and are profiled
FUSED_SERVE = ("llama3.2-3b", "recurrentgemma-9b", "xlstm-1.3b", "whisper-base",
               "llama-3.2-vision-90b")
# #7 calls per decode step of each layer kind ('dec': self, then cross)
GQA_PER_LAYER = {"attn": 1, "swa": 1, "cross": 1, "dec": 2}
XGATE = 0.5     # every cross layer's tanh gate on the card (0 at init: the path would not show)


def gqa_case(gen, fmt, lens, N, Hkv, g, dh, window=0, page=PAGE, cross=False):
    """A GQA cache of capacity N (``window``: a ring; rounded up to the page)
    whose row b was prefilled with ``lens[b]`` tokens of random K, V through
    the port's ``gqa_prefill``, and a query per row at position
    ``lens[b] - 1`` (``cross``: at ``CROSS_POS``, as a cross layer's)."""
    import torch
    from repro_torch.core.kvcache import CacheConfig, GQACache, gqa_prefill, init_gqa_cache
    cfg = CacheConfig(fmt=fmt, page_size=page, window=window)
    rows = []
    for n in lens:
        c = init_gqa_cache(cfg, 1, N, Hkv, dh, device="cuda")
        if n:
            c = gqa_prefill(c, cfg, torch.randn(1, n, Hkv, dh, generator=gen, device="cuda"),
                            torch.randn(1, n, Hkv, dh, generator=gen, device="cuda"))
        rows.append(c)
    cache = GQACache(*(torch.cat(ts).contiguous() for ts in zip(*rows)))
    q = torch.randn(len(lens), Hkv * g, dh, generator=gen, device="cuda")
    pos = torch.tensor([CROSS_POS if cross else max(n - 1, 0) for n in lens],
                       dtype=torch.int32, device="cuda")
    return q, cache, pos


def gqa_bound(cache, pos, window, g, fmt):
    """Least time of one #7 call: the valid slots' K, V and scales, slot_pos
    for every slot, q and o, at HBM rate, against the QK + PV operations of
    the valid slots at the format's tensor-core peak."""
    from repro_torch.kernels.gqa_decode.ref import _valid_slots
    B, N, Hkv, dh = cache.k.shape
    esize = cache.k.element_size()
    valid = int(_valid_slots(cache.slot_pos, pos, window).sum())
    nbytes = valid * Hkv * (2 * dh * esize + 8) + B * N * 4 + 2 * B * Hkv * g * dh * 4
    return _bound(nbytes, valid * Hkv * g * 4 * dh, PEAK[fmt])


def mla_ptxas() -> None:
    """Registers and spill bytes of every MLA decode instantiation (format,
    head-tile width, single pass, AMLA, sink, verify), from the build's
    -Xptxas -v report: one line (reported, not gated)."""
    from repro_torch.kernels import _lib
    rows = {}
    for name, row in ptxas_entries(_lib.BUILD_LOG).items():
        m = re.search(r"decode_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
        if m:
            rows["".join(m.groups())] = list(row)
    emit(phase="kernels", check="MLA decode ptxas",
         key="fmt width single_pass amla sink verify -> [registers, spill bytes]",
         spilling={k: v for k, v in rows.items() if v[1]}, instantiations=rows)


def fetch_ptxas() -> dict:
    """Registers and spills of K1's three instantiations (fp8, int8, bf16
    content), from the build's -Xptxas -v report; raises on a spill or a
    missing report."""
    from repro_torch.kernels import _lib
    rows = {}
    for name, (regs, spill) in ptxas_entries(_lib.BUILD_LOG).items():
        m = re.search(r"fetch_dequant_kernelILi(\d)E", name)
        if m:
            rows[f"fmt {m[1]}"] = dict(registers=regs, spill_bytes=spill)
    if len(rows) != 3 or any(None in r.values() for r in rows.values()):
        raise AssertionError(f"K1: ptxas report incomplete: {rows}")
    if any(r["spill_bytes"] for r in rows.values()):
        raise AssertionError(f"K1: ptxas reports spills: {rows}")
    return rows


def token_prep_ptxas() -> dict:
    """Registers and spills of D's and #9's instantiations (fp8, int8; the
    MLA widths and the runtime widths), from the build's -Xptxas -v report;
    raises on a spill or a missing report."""
    from repro_torch.kernels import _lib
    rows = {}
    for name, (regs, spill) in ptxas_entries(_lib.BUILD_LOG).items():
        m = re.search(r"(fused_q_quant|k_append)_kernelILi(\d)ELi(\d+)ELi(\d+)E", name)
        if m:
            widths = "runtime" if m[3] == "0" else f"{m[3]}/{m[4]}"
            rows[f"{'D' if m[1] == 'fused_q_quant' else '#9'} fmt {m[2]} {widths}"] = dict(
                registers=regs, spill_bytes=spill)
    want = {f"{k} fmt {f} {w}" for k in ("D", "#9") for f in (0, 1)
            for w in ("runtime", f"{D_C}/{D_R}")}
    if set(rows) != want or any(None in r.values() for r in rows.values()):
        raise AssertionError(f"D / #9: ptxas report incomplete: {rows}")
    if any(r["spill_bytes"] for r in rows.values()):
        raise AssertionError(f"D / #9: ptxas reports spills: {rows}")
    return rows


def gqa_ptxas() -> dict:
    """Registers and spills of every #7 instantiation (format, head-tile
    width, head-size bucket: d_head <= 128 or 256), from the build's -Xptxas
    -v report: one line; raises on a spill or a missing report."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.gqa_decode import kernel as GK
    fmts = {v: k for k, v in GK.FMT_CODES.items()}
    rows = {}
    for name, (regs, spill) in ptxas_entries(_lib.BUILD_LOG).items():
        if "gqa_decode_kernel" in name:
            f, w, dh = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", name).groups()
            rows[f"{fmts[int(f)]} width {w} dh<={dh}"] = dict(registers=regs, spill_bytes=spill)
    want = {f"{f} width {w} dh<={dh}" for f in GK.FMT_CODES for w in GK.GQA_HEAD_WIDTHS
            for dh in (128, 256)}
    if set(rows) != want or any(None in r.values() for r in rows.values()):
        raise AssertionError(f"#7: ptxas report incomplete: {rows}")
    spills = {k: r for k, r in rows.items() if r["spill_bytes"]}
    if spills:
        raise AssertionError(f"#7: ptxas reports spills: {spills}")
    emit(phase="kernels", check="#7 ptxas", instantiations=rows)
    return rows


def gqa_checks(gen, records):
    """#7 against its plain version on the card, within rtol / atol 1e-5
    (NaN rows, from a row with no token, equal), bitwise equality recorded;
    every head-tile width bitwise equal to every other and to the rule's
    pick; ms (CUDA-graph replay) at the rule's pick, plain ms and bound ms
    per case, with the registers and spills of the instantiation it runs;
    one line with each width's ms beside the pick. The bf16 cases of
    ``GQA_LIBRARY`` are also timed as ``scaled_dot_product_attention`` over
    the same bf16 K / V (the valid slots as its mask, ``enable_gqa``), with
    its largest difference from the kernel (``library``)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.gqa_decode import kernel as GK
    from repro_torch.kernels.gqa_decode import ops as GO
    regs = gqa_ptxas()
    widths = GK.GQA_HEAD_WIDTHS
    sweep = []
    for tag, fmt, lens, N, Hkv, g, dh, window, block in GQA_CASES:
        q, cache, pos = gqa_case(gen, fmt, lens, N, Hkv, g, dh, window,
                                 cross=tag.startswith("gqa_cross"))
        kw = dict(window=window, block_n=block, fmt=fmt)
        by_width = {}
        for w in widths:
            with GK.forced_gqa_head_width(w):
                by_width[w] = GO.gqa_decode(q, cache, pos, **kw)
        got = GO.gqa_decode(q, cache, pos, **kw)
        for w, o in by_width.items():
            check_bitwise(f"{tag} #7 width {w} vs width {widths[0]}", o, by_width[widths[0]])
        check_bitwise(f"{tag} #7 the rule's pick vs width {widths[0]}", got, by_width[widths[0]])
        want = GO.gqa_decode(q, cache, pos, use_kernel=False, **kw)
        err = check_close(f"{tag} #7", got, want, equal_nan=True, **TOL)
        empty = [b for b, n in enumerate(lens) if n == 0]
        if not (torch.isnan(got[empty]).all() and torch.isfinite(
                got[[b for b in range(len(lens)) if b not in empty]]).all()):
            raise AssertionError(f"{tag} #7: NaN only on the rows with no token expected")
        bitwise = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        args = (q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.slot_pos, pos)
        bound = gqa_bound(cache, pos, window, g, fmt)
        rec = dict(max_abs_err=err, ms=kernel_ms(lambda: GK.gqa_decode_cuda(*args, **kw)),
                   plain_ms=time_ms(lambda: GK.gqa_decode_plain(*args, **kw)),
                   bound_ms=bound[0], bound_by=bound[1])
        if tag in GQA_LIBRARY:
            rec["library"] = sdpa_library(q, cache, pos, window, got)
        records[("gqa_decode", tag, 0)] = rec
        pick = GK.gqa_head_width(len(lens), Hkv, g, _lib.sm_count(0))
        emit(phase="kernels", case=tag, kernel="#7 gqa_decode", fmt=fmt, lens=lens,
             capacity=cache.capacity, kv_heads=Hkv, g=g, dh=dh, window=window, block=block,
             position=int(pos[0]) if tag.startswith("gqa_cross") else "lens - 1",
             max_abs_err=err, bitwise=bitwise, bitwise_widths=True, width=pick,
             ptxas=regs[f"{fmt} width {pick} dh<={128 if dh <= 128 else 256}"],
             **{k: v for k, v in rec.items() if k != "max_abs_err"})
        if tag in GQA_SWEEP:
            sweep.append(dict(case=tag, picked=pick, ms_by_width=gqa_width_ms(
                lambda: GK.gqa_decode_cuda(*args, **kw))))
    # llama3.2-3b's heads at batches past the SMs: at 32 rows the rule picks
    # the wide tile; at 8 rows in bf16, width 1 gives 192 blocks and the ring
    # is cut so that two blocks share an SM
    for tag, fmt, lens in (("gqa_llama_batch32", "fp8_e4m3", [520] * 32),
                           ("gqa_llama_none_batch8", "none", [520] * 8)):
        q, cache, pos = gqa_case(gen, fmt, lens, 640, 8, 3, 128)
        kw = dict(window=0, block_n=PAGE, fmt=fmt)
        by_width = {}
        for w in widths:
            with GK.forced_gqa_head_width(w):
                by_width[w] = GO.gqa_decode(q, cache, pos, **kw)
            check_bitwise(f"{tag} #7 width {w} vs width {widths[0]}", by_width[w],
                          by_width[widths[0]])
        check_close(f"{tag} #7", by_width[widths[0]],
                    GO.gqa_decode(q, cache, pos, use_kernel=False, **kw), **TOL)
        args = (q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.slot_pos, pos)
        sweep.append(dict(case=tag, fmt=fmt, picked=GK.gqa_head_width(len(lens), 8, 3,
                                                                      _lib.sm_count(0)),
                          ms_by_width=gqa_width_ms(lambda: GK.gqa_decode_cuda(*args, **kw))))
    emit(phase="kernels", check="gqa head-tile widths", sms=_lib.sm_count(0), widths=sweep)


def sdpa_library(q, cache, pos, window, kernel_out) -> dict:
    """One ``scaled_dot_product_attention`` call on a bf16 #7 case's inputs
    (q cast to bf16 [B, H, 1, dh], K / V [B, Hkv, N, dh] as stored, the
    valid slots as a boolean mask, ``enable_gqa``, #7's softmax scale): its
    device ms (CUDA-graph replay, as ``kernel_ms``) and its largest
    difference from #7's output over the rows with a valid slot. Timed here
    only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.gqa_decode.ref import _valid_slots
    B, H, dh = q.shape
    qb = q.to(torch.bfloat16)[:, :, None, :].contiguous()
    kb = cache.k.permute(0, 2, 1, 3).contiguous()
    vb = cache.v.permute(0, 2, 1, 3).contiguous()
    valid = _valid_slots(cache.slot_pos, pos, window)
    mask = valid[:, None, None, :].contiguous()

    def call():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=dh ** -0.5,
                                              enable_gqa=True)

    o = call()[:, :, 0].float()
    rows = valid.any(dim=1)
    diff = float((o[rows] - kernel_out[rows]).abs().max())
    return dict(call="torch.nn.functional.scaled_dot_product_attention", ms=kernel_ms(call),
                max_abs_diff=diff)


def gqa_width_ms(fn) -> dict:
    """Each instantiated head-tile width's kernel ms for one #7 call."""
    from repro_torch.kernels.gqa_decode import kernel as GK
    out = {}
    for w in GK.GQA_HEAD_WIDTHS:
        with GK.forced_gqa_head_width(w):
            out[w] = kernel_ms(fn)
    return out


class _CountDecodeSteps:
    """Counts ``transformer.decode_step`` calls inside the block."""

    def __enter__(self):
        from repro_torch.models import transformer as T
        self.T, self.orig, self.n = T, T.decode_step, 0

        def counted(*a, **kw):
            self.n += 1
            return self.orig(*a, **kw)
        T.decode_step = counted
        return self

    def __exit__(self, *exc):
        self.T.decode_step = self.orig


def phase_gqa_serve(arch, layers, batch, prompt_len, gen_steps, fmts, fused=False):
    """``serve.generate`` on one GQA, recurrent or encoder-family model at
    full width (depth cut to ``layers`` when non-zero), weights from a
    seeded generator: the kernel backend against the reference backend per
    format; with ``fused``, the fp8 kernel run repeated through
    ``serve.generate_fused`` (``fused_gate``). The encoder families get
    random aux embeddings [batch, n_aux_tokens, d] from the same generator
    and every cross layer's gate set to 0.5 (it starts at zero, where a
    cross layer adds nothing), and their fused run must be bitwise equal to
    the step loop. The kernel runs and the fused run are this path's counted
    runs: #7 launches exactly once per ``attn`` / ``swa`` / ``cross`` layer
    and twice per ``dec`` layer (self, then cross) and decode step
    (recurrentgemma's ``rglru`` layers launch nothing). Returns (launches,
    cfg, params, prompts, aux)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    full = get_config(arch)
    base = dataclasses.replace(full, n_layers=layers) if layers else full
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    params = T.init_model(gen, base, device="cuda")
    for p in params["layers"]:
        if "xgate" in p:
            p["xgate"].fill_(XGATE)
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase="gqa_serve_init", arch=arch, layers=base.n_layers,
         kinds=list(base.layer_kinds), params=n_params, seconds=time.time() - t0,
         gib=torch.cuda.memory_allocated() / 2**30,
         reduced=f"{base.n_layers} of {full.n_layers} layers" if layers else None)
    prompts = torch.randint(0, base.vocab_size, (batch, prompt_len), generator=gen,
                            device="cuda")
    aux = torch.randn((batch, base.n_aux_tokens, base.d_model), generator=gen,
                      device="cuda") if base.n_aux_tokens else None
    n_gqa = sum(GQA_PER_LAYER.get(k, 0) for k in base.layer_kinds)
    kernel = "gqa_decode" if n_gqa else None    # xlstm-1.3b: no kernel on its path
    launches: dict = {}
    for fmt in fmts:
        def cfg_of(backend):
            return dataclasses.replace(base, kv_fmt=fmt, decode_backend=backend,
                                       use_kernels=backend == "kernel")
        r_toks, r_tps, r_logits = serve.generate(cfg_of("ref"), params, prompts, gen_steps,
                                                 aux_embed=aux, return_logits=True)
        torch.cuda.synchronize()
        _lib.reset_launches()                  # the GQA serve path starts here
        with _CountDecodeSteps() as steps:
            toks, tps, logits = serve.generate(cfg_of("kernel"), params, prompts, gen_steps,
                                               aux_embed=aux, return_logits=True)
        torch.cuda.synchronize()
        run_launches = dict(_lib.LAUNCHES)     # ... and ends here
        lbl = f"serve {arch} fmt={fmt}"
        if not (torch.isfinite(logits).all() and torch.isfinite(r_logits).all()):
            raise AssertionError(f"{lbl}: non-finite logits")
        first = float((logits[:, 1] - r_logits[:, 1]).abs().max()
                      / r_logits[:, 1].abs().max())
        if first > 1e-2:
            raise AssertionError(f"{lbl}: first-step logits rel err {first}")
        if not torch.equal(toks[:, 0], r_toks[:, 0]):
            raise AssertionError(f"{lbl}: prefill tokens differ")
        want = {kernel: n_gqa * steps.n} if kernel else {}
        if run_launches != want:
            raise AssertionError(f"{lbl}: launches {run_launches} != {want}: {n_gqa} #7 "
                                 f"calls per step x {steps.n} decode steps")
        _add(launches, run_launches)
        if fused and fmt == "fp8_e4m3":
            _add(launches, fused_gate(f"{arch} fmt={fmt}", cfg_of("kernel"), params, prompts,
                                      (toks, tps, logits), (r_toks, r_tps, r_logits),
                                      kernel, gen_steps, per_step=n_gqa, aux=aux,
                                      need_bitwise=aux is not None))
        emit(phase="gqa_serve", arch=arch, layers=base.n_layers, batch=batch,
             prompt=prompt_len, gen=gen_steps, fmt=fmt, window=base.window,
             n_aux_tokens=base.n_aux_tokens, gqa_calls_per_step=n_gqa,
             decode_steps=steps.n, launches=run_launches, tok_per_s=tps,
             ref_tok_per_s=r_tps, greedy_agreement_vs_ref=float((toks == r_toks).float().mean()),
             first_step_logits_rel_err=first,
             max_logits_rel_err=float((logits - r_logits).abs().max() / r_logits.abs().max()))
    return launches, base, params, prompts, aux


# phase 8c: training (launch/train.train_loop on the card; no kernel of its own)
TRAIN_RUNS = [  # (arch, layers kept (0 = all), batch, seq, steps, lr)
    ("mla-7b", 4, 8, 512, 20, 3e-4),
    # whisper's text context is 448 tokens; its encoder reads 1,500 frames
    ("whisper-base", 0, 8, 448, 20, 3e-4)]
TRAIN_CKPT = "build/chip_smoke_train_ckpt"


def train_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step: 6 x parameters x tokens (forward
    and backward of every matmul), the decoder's over batch x seq tokens and
    whisper's encoder's over batch x n_aux_tokens frames; attention's own
    products are left out."""
    enc = cfg.encoder_layers * (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
                                + cfg.n_heads * cfg.d_head * cfg.d_model
                                + 3 * cfg.d_model * cfg.d_ff)
    return 6.0 * ((cfg.param_count() - enc) * batch * seq + enc * batch * cfg.n_aux_tokens)


TRAIN_MESH_TURNS = 3            # timed step pairs (meshed, plain) of phase 8c


def train_mesh_checks(cfg, batch, seq, steps, lr, out, mesh) -> dict:
    """The meshed loop ``out`` (``train_loop`` on ``mesh``, a world of one)
    against ``make_train_step`` on plain tensors from the same seed and
    batches: step 1's loss and grad_norm bitwise, steps 2-3 within rel
    1e-6 (the embedding's backward sums with atomics); then the meshed step
    (``train.sharded_step`` on the plain state placed on ``mesh``) and the
    plain step timed in turns from that state, ``TRAIN_MESH_TURNS`` each
    (synchronized wall per step)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import sharded_step
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_adamw, tree_map
    fn = ST.make_train_step(cfg, AdamWConfig(lr=lr), warmup_steps=max(2, steps // 10),
                            total_steps=steps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p = T.init_model(gen, cfg, device="cuda")
    o = init_adamw(p)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
                    n_aux_tokens=cfg.n_aux_tokens, d_model=cfg.d_model)

    def batch_at(i):
        return {k: v.to("cuda") for k, v in synth_batch(dc, i).items()}
    plain = []
    for i in range(3):
        p, o, m = fn(p, o, batch_at(i), i)
        plain.append((float(m["loss"]), float(m["grad_norm"])))
    meshed = list(zip(out["losses"][:3], out["grad_norms"][:3]))
    if meshed[0] != plain[0]:
        raise AssertionError(f"train mesh: step 1 {meshed[0]} != plain {plain[0]}")
    rel = max(abs(a - b) / abs(b) for mp, pp in zip(meshed[1:], plain[1:])
              for a, b in zip(mp, pp))
    if rel > 1e-6:
        raise AssertionError(f"train mesh: steps 2-3 {meshed[1:]} vs plain {plain[1:]}")
    named = (SH.to_named(SH.param_pspecs(p, mesh), mesh),
             SH.to_named(SH.param_pspecs(o, mesh), mesh))
    mp_, mo_ = SH.place(tree_map(torch.clone, p), named[0]), \
        SH.place(tree_map(torch.clone, o), named[1])
    mstep = sharded_step(fn, mesh)
    bnamed = SH.to_named(SH.batch_pspecs(batch_at(0), mesh), mesh)
    t_mesh, t_plain, turn_rel = [], [], 0.0
    for i in range(3, 3 + TRAIN_MESH_TURNS):
        b = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp_, mo_, mm = mstep(mp_, mo_, SH.place(b, bnamed), i)
        lm = float(mm["loss"])
        torch.cuda.synchronize()
        t_mesh.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        p, o, m = fn(p, o, b, i)
        lp = float(m["loss"])
        torch.cuda.synchronize()
        t_plain.append(time.perf_counter() - t0)
        turn_rel = max(turn_rel, abs(lm - lp) / abs(lp))
    return dict(step1_loss_gnorm_bitwise=True, steps23_max_rel=rel, plain_first3=plain,
                meshed_ms_per_step=statistics.median(t_mesh) * 1e3,
                plain_ms_per_step=statistics.median(t_plain) * 1e3,
                meshed_ms=[t * 1e3 for t in t_mesh], plain_ms=[t * 1e3 for t in t_plain],
                turns_max_loss_rel=turn_rel)


def phase_train(smi) -> None:
    """``launch.train.train_loop`` on the card through its mesh (an NCCL
    world of one started here by ``make_host_mesh``, a (1, 1) mesh,
    destroyed at the end), float32 (TF32 off), AdamW, remat per superblock:
    mla-7b at full width cut to 4 of 30 layers (1.15 B parameters; params + grads + two moments ~18.5 GB; all 30 layers would
    be ~95 GB) and whisper-base at full width and depth with its aux
    embeddings, 20 steps each from seeded weights and ``synth_batch``: every
    loss finite and falling by tests/test_train_loop.py's own assertion
    (mean of the last 3 < mean of the first 3 - 0.1); ms per step (median of
    the steps after the first), tokens/s, peak memory, model FLOP/s against
    the 67 TFLOP/s float32 peak. Then whisper-base again, preempted after
    step 10 of 20 (its checkpoint written), and restarted from that
    checkpoint to step 20: the resumed losses within 1e-3 of the unbroken
    run's steps 10-19 (the embedding's backward sums with atomics, so the
    bits may differ)."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    mesh = make_host_mesh(1, "cuda")
    unbroken = {}
    for arch, layers, batch, seq, steps, lr in TRAIN_RUNS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers) if layers else full
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = train_loop(cfg, steps=steps, batch=batch, seq=seq, ckpt_dir=None, lr=lr,
                         log_every=5, device="cuda", mesh=mesh)
        wall = time.time() - t0
        losses = out["losses"]
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train {arch}: non-finite loss {losses}")
        if not last < first - 0.1:
            raise AssertionError(f"train {arch}: loss did not fall ({first} -> {last})")
        step_s = statistics.median(out["step_s"][1:])
        flops = train_flops(cfg, batch, seq)
        emit(phase="train", arch=arch, layers=cfg.n_layers,
             reduced=f"{cfg.n_layers} of {full.n_layers} layers" if layers else None,
             params=cfg.param_count(), batch=batch, seq=seq,
             n_aux_tokens=cfg.n_aux_tokens, steps=steps, lr=lr, loss_first3=first,
             loss_last3=last, losses=losses, first_step_s=out["step_s"][0],
             ms_per_step=step_s * 1e3, tokens_per_s=batch * seq / step_s,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             model_flops_per_step=flops, model_tflops_per_s=flops / step_s / 1e12,
             share_of_f32_peak=flops / step_s / PEAK["f32"], wall_s=wall,
             stragglers=out["flagged_stragglers"], mesh=list(mesh.shape),
             process_group=str(dist.get_backend()))
        unbroken[arch] = (cfg, batch, seq, steps, lr, losses)
        if arch == "mla-7b":
            params = out.pop("params")
            del params
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.time()
            emit(phase="train_mesh", arch=arch, layers=cfg.n_layers, batch=batch, seq=seq,
                 gpu=smi, **train_mesh_checks(cfg, batch, seq, steps, lr, out,
                                                           mesh), checks_s=time.time() - t1)
        del out
        gc.collect()
        torch.cuda.empty_cache()

    class PreemptAfter:
        """``requested`` turns True at the loop's 10th check (after step 10)."""

        def __init__(self):
            self.count = 0

        @property
        def requested(self):
            self.count += 1
            return self.count >= 10

    cfg, batch, seq, steps, lr, losses = unbroken["whisper-base"]
    shutil.rmtree(ROOT / TRAIN_CKPT, ignore_errors=True)
    kw = dict(steps=steps, batch=batch, seq=seq, ckpt_dir=str(ROOT / TRAIN_CKPT), lr=lr,
              log_every=100, device="cuda", mesh=mesh)
    cut = train_loop(cfg, preemption=PreemptAfter(), ckpt_every=1000, **kw)
    rest = train_loop(cfg, ckpt_every=1000, **kw)
    diff = max(abs(a - b) for a, b in zip(rest["losses"], losses[10:]))
    if cut["status"] != "preempted" or cut["final_step"] != 10 or rest["status"] != "done" \
            or rest["final_step"] != steps or len(rest["losses"]) != steps - 10 or diff > 1e-3:
        raise AssertionError(f"train preempt / resume: {cut['status']} at {cut['final_step']}, "
                             f"{rest['status']} at {rest['final_step']} with "
                             f"{len(rest['losses'])} losses, max diff {diff}")
    emit(phase="train_resume", arch="whisper-base", preempted_at=cut["final_step"],
         resumed_to=rest["final_step"], resumed_losses=rest["losses"],
         max_loss_diff_vs_unbroken=diff, bitwise_vs_unbroken=rest["losses"] == losses[10:])
    shutil.rmtree(ROOT / TRAIN_CKPT, ignore_errors=True)
    del cut, rest
    gc.collect()
    dist.destroy_process_group()


# phase 8d: one dry-run cell on the host (fake 256-rank world, meta tensors)
DRYRUN_CELL = dict(arch="mla-7b", shape="decode_32k", mesh_kind="pod", extra={"n_layers": 2},
                   variant="baseline")
DRYRUN_LIMIT_S = 30.0


def phase_dryrun() -> None:
    """``launch.dryrun.run_cell`` on ``DRYRUN_CELL`` in a subprocess (its
    own fake process group of 256 ranks; no card): exit 0, status ok, 256
    chips, within ``DRYRUN_LIMIT_S``; the record on its own line."""
    import os
    code = ("import json; from repro_torch.launch import dryrun as D; D.fake_world(256); "
            f"print(json.dumps(D.run_cell(**{DRYRUN_CELL!r}), default=str))")
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.time() - t0
    if p.returncode != 0:
        raise AssertionError(f"dry run: exit {p.returncode}: {p.stderr[-2000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    if rec["status"] != "ok" or rec["n_chips"] != 256 or wall > DRYRUN_LIMIT_S:
        raise AssertionError(f"dry run: {rec['status']}, {rec.get('n_chips')} chips, {wall:.1f} s")
    emit(phase="dryrun", subprocess_s=wall, limit_s=DRYRUN_LIMIT_S, record=rec)


# phase 9: deepseek-v3-mla, full width, one layer
DS_RUNS = [  # (paged, kv_splits, rescale, sink_tokens)
    (False, 0, "fma", 0), (True, 0, "fma", 0), (True, 4, "fma", 0), (True, 4, "amla", 0)]
DS_FUSED = [(True, 0, "fma", 0), (False, 0, "fma", 0), (True, 4, "fma", 0)]
# a decode batch whose MoE calls take C = max(1, int(64 * 8 * 1.25 / 256)) = 2
# rows per expert (prompt 128 keeps its prefill small)
DS_WIDE = (64, 128)
DS_ENGINE = ["--batch", "4", "--max-batch", "2", "--prompt-len", "512", "--prefill-chunk",
             "256", "--prefill-budget", "512", "--spec-draft", "4", "--gen", "16"]


def phase_deepseek():
    """deepseek-v3-mla at full width (d_model 7,168, 128 heads, q-LoRA 1,536,
    256 experts top-8 + 1 shared, vocab 129,280) cut to one layer (12.43 B
    parameters, ~50 GB in float32; two layers do not fit in 80 GB):
    ``serve.generate`` on ``DS_RUNS`` (``serve_runs``' gates) and
    ``serve.generate_fused`` on ``DS_FUSED`` (``fused_gate``), both again at
    ``DS_WIDE`` (batch 64, where the decode MoE calls take two rows per
    expert) on paged kv0, held to the plain backend; then the
    engine with chunked prefill and speculative decoding, held to the plain
    backend forced onto its tokens, K1 once per layer per chunk step and K2
    once per layer per verify step, its agreement with ``generate``
    reported, not gated: the expert capacity depends on how many tokens
    share a MoE call, so the engine's batches and ``generate``'s static
    batch drop different tokens, in the reference too. Then one decode
    step, eager and through the captured graph, under torch.profiler beside
    the expert weights' byte bound: the
    MoE computes every expert of its [E, C, d] buffer, so a step reads all
    routed expert weights. Frees the model. Returns the launches."""
    import torch
    base, params, prompts = init_full("deepseek-v3-mla", layers=1)
    launches, kern, refs = serve_runs(base, params, prompts, DS_RUNS)
    for run in DS_FUSED:
        _add(launches, fused_gate(f"deepseek {run}", serve_cfg(base, run, "kernel"), params,
                                  prompts, kern[run], refs[run],
                                  decode_kernel(run, heads=base.n_heads)))
    batch, plen = DS_WIDE
    wide = torch.randint(0, base.vocab_size, (batch, plen),
                         generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    m_cfg = base.moe
    cap = max(1, int(batch * m_cfg.top_k * m_cfg.capacity_factor / m_cfg.n_experts))
    run = DS_FUSED[0]
    got, kern, refs = serve_runs(base, params, wide, [run])
    _add(launches, got)
    _add(launches, fused_gate(f"deepseek {run} batch {batch}", serve_cfg(base, run, "kernel"),
                              params, wide, kern[run], refs[run],
                              decode_kernel(run, *serve_shape(wide), base.n_heads)))
    emit(phase="deepseek_wide", batch=batch, prompt=plen, decode_capacity_per_expert=cap,
         held_to_plain=["generate", "generate_fused"])
    del kern, refs, wide
    kit = engine_kit(base, params)
    args = kit.parse(DS_ENGINE)
    eng, res, wall, e_prompts = kit.run(kit.kcfg, args)
    m = kit.gate("deepseek engine", eng, res)
    if not (eng.dispatches["chunk"] and eng.dispatches["verify"]):
        raise AssertionError(f"deepseek engine: dispatches {dict(eng.dispatches)} lack a "
                             "chunk or a verify step")
    plain, p_wall, worst, flips = kit.held_to_plain("deepseek engine kernel vs plain backend",
                                                    eng, res, kit.pcfg, args)
    agree, diverge = oracle_agreement(kit.oracle(kit.kcfg, e_prompts, args.gen), res,
                                      e_prompts)
    sp = m["speculative"]
    emit(phase="deepseek_engine", flags=DS_ENGINE, seconds=wall, plain_seconds=p_wall,
         steps=m["steps"], tok_per_s=m["wall"]["decode_tok_per_s"],
         verify_steps=sp["verify_steps"], drafted=sp["drafted_tokens"],
         accepted=sp["accepted_tokens"], chunk_widths=m["prefill"]["traces"],
         rows_vs_plain=len(eng.step_logits), max_row_rel_err_vs_plain=worst,
         near_tie_flips_vs_plain=flips, generate_agreement=agree,
         generate_divergence=diverge, dispatches=dict(eng.dispatches),
         launches=eng.launches)
    for k, v in kit.launches.items():
        launches[k] = launches.get(k, 0) + v
    expert_bytes = 4 * base.n_layers * m_cfg.n_experts * 3 * base.d_model * m_cfg.d_ff_expert
    phase_profile(base, params, prompts, runs=((True, 0, "fma"), (False, 0, "fma")),
                  expert_weight_bytes=expert_bytes,
                  expert_weight_bound_ms=expert_bytes / HBM_BYTES_PER_S * 1e3)
    del params, kit, eng, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _timed(rec, case, splits):
    return dict(case=case, splits=splits, ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"])


def summary_line(records, launches, long_tokens):
    """One entry per kernel (and AMLA / verify mode): the main-shape
    measurement, the long case beside it, launches on the main paths; the
    MLA kernels' rows also carry their times at 128 heads (deepseek-v3-mla),
    #7's at d_head 64 (granite-3-2b), 256 (recurrentgemma-9b) and the cross
    shapes, and its bf16 cases' library times (``library``; ``library_ms``
    at llama's serving shape)."""
    rows = []
    for name, (source, replaces, mode) in KERNELS.items():
        s_serve, s_long = SUMMARY_SPLITS[_kind(name)]
        (tag, S), (ltag, lS) = SUMMARY_CASES.get(
            name, (("serve_shape", s_serve), ("long_32k", s_long)))
        short, longc = records[(name, tag, S)], records[(name, ltag, lS)]
        err = max(v["max_abs_err"] for k, v in records.items() if k[0] == name)
        extra = {}
        for key, cases in SUMMARY_EXTRA.items():
            (etag, eS), (eltag, elS) = cases(name, s_serve, s_long)
            if "ms" in records.get((name, etag, eS), {}) and \
                    "ms" in records.get((name, eltag, elS), {}):
                extra[key] = dict(_timed(records[(name, etag, eS)], etag, eS),
                                  long_ctx=_timed(records[(name, eltag, elS)], eltag, elS))
        if name in B64_CASE:   # D and #9: batch 64, the launch floor of the same call
            extra["b64"] = _timed(records[(name, B64_CASE[name], 1)], B64_CASE[name], 1)
            extra["launch_floor_ms"] = short["launch_floor_ms"]
            extra["ms_eps_row"] = short["ms_eps_row"]   # the same call on an all-zero row
        library_ms = None
        if name in LIBRARY_ROWS:
            main_case, cases = LIBRARY_ROWS[name]
            library_ms = records[(name, main_case, 0)]["library"]["ms"]
            extra["library"] = {c: dict(records[(name, c, 0)]["library"],
                                        kernel_ms=records[(name, c, 0)]["ms"]) for c in cases}
            extra["library_case"] = main_case
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, mode=mode,
            launches=launches.get(name, 0), max_abs_err=err, ms=short["ms"],
            plain_ms=short["plain_ms"], bound_ms=short["bound_ms"],
            bound_by=short["bound_by"], library_ms=library_ms, case=tag, splits=S,
            off_main_path=OFF_PATH.get(name), folded_into=FOLDED_INTO.get(name),
            long_ctx=dict(case=ltag, tokens=longc.get("tokens", long_tokens), splits=lS,
                          ms=longc["ms"],
                          plain_ms=longc["plain_ms"], bound_ms=longc["bound_ms"],
                          bound_by=longc["bound_by"]), **extra))
    return json.dumps({"kernels": rows})


def main() -> int:
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the repository beside this file)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K

    # 1. build: the kernels, and beside them (in parallel) a build without the
    # q_len > 1 verify code for the q_len = 1 comparison of phase 2
    t0 = time.time()
    variant: dict = {}

    def build_variant():
        try:
            variant["path"] = _lib.build(verbose=True, defines=NO_VERIFY)
        except Exception as exc:   # re-raised below, in the main thread
            variant["error"] = exc

    variant_build = threading.Thread(target=build_variant)
    variant_build.start()
    _lib.lib(verbose=True)
    variant_build.join()
    if "error" in variant:
        raise variant["error"]
    variant_lib = _lib.load(variant["path"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    ptxas = [ln.split("ptxas info    : ")[-1].strip()
             for ln in _lib.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Function properties" in ln]
    emit(phase="build", seconds=time.time() - t0, nvcc_seconds=_lib.BUILD_SECONDS,
         torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas)
    print(smi, flush=True)

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    scale = 1.0 / (128 + D_R) ** 0.5             # mla-7b softmax scale
    records: dict = {}
    t0 = time.time()
    # A's sm90 design at the cells' shapes, on the wrapper's own route; then
    # every kernel's bits, with A pinned to its exact design (the sm90 design
    # takes A's fp8 FMA q_len = 1 split calls at the MLA widths, within
    # tolerances: its row here, tests/test_torch_sm90_cuda.py)
    sm90_checks(gen, scale, records)
    with K.forced_design("exact"):
        decode_checks(gen, "fp8_e4m3", [527, 512, 520, 513], 5, [4, 1], scale,
                      tag="serve_shape", timing=True, records=records)
        long_lens = [0, PAGE, 32768, 20000]
        decode_checks(gen, "fp8_e4m3", long_lens, 256, [1, 4, 8], scale, tag="long_32k",
                      timing=True, records=records)
        decode_checks(gen, "fp8_e4m3", [527, 512, 520, 513], 5, [4, 1], scale, tag="sink",
                      timing=True, records=records, layouts=("contiguous",), sink_tokens=4)
        emit(phase="kernels", case="sink", sink_tokens=4,
             ms={f"{k[0]} S={k[2]}": v["ms"] for k, v in records.items()
                 if k[1] == "sink" and "ms" in v},
             ms_unguarded={f"{k[0]} S={k[2]}": records[(k[0], "serve_shape", k[2])]["ms"]
                           for k, v in records.items() if k[1] == "sink" and "ms" in v})
        for fmt in ("int8", "none"):
            decode_checks(gen, fmt, [0, PAGE, 4000], 32, [1, 4], scale, tag=f"small_{fmt}",
                          timing=False, records=records)
        k_append_checks(gen, "fp8_e4m3", 4, 640, tag="serve_shape", timing=True, records=records)
        k_append_checks(gen, "fp8_e4m3", 4, 32768, tag="long_32k", timing=True, records=records)
        k_append_checks(gen, "fp8_e4m3", 64, 640, tag="b64", timing=True, records=records)
        k_append_checks(gen, "int8", 3, 256, tag="small_int8", timing=False, records=records)
        token_prep_checks(gen, records)
        fetch_checks(gen, records, engine_pages=8)
        verify_checks(gen, [3, 512, 777, 1100], 9, 5, [1, 4, 8], scale, tag="verify_shape",
                      records=records)
        verify_checks(gen, long_lens, 256, 4, [1, 4, 8], scale, tag="long_32k_verify",
                      records=records)
        # the same kernels at deepseek-v3-mla's 128 heads (its softmax scale is
        # mla-7b's: d_head 128, d_rope 64)
        serve_lens = [527, 512, 520, 513]
        decode_checks(gen, "fp8_e4m3", serve_lens, 5, [4, 1], scale, tag="serve_shape_h128",
                      timing=True, records=records, heads=DS_HEADS)
        decode_checks(gen, "fp8_e4m3", long_lens, 256, [1, 4, 8], scale, tag="long_32k_h128",
                      timing=True, records=records, heads=DS_HEADS)
        verify_checks(gen, serve_lens, 5, 5, [1, 4], scale, tag="serve_shape_h128_verify",
                      records=records, heads=DS_HEADS)
        verify_checks(gen, long_lens, 256, 4, [1, 4, 8], scale, tag="long_32k_h128_verify",
                      records=records, heads=DS_HEADS)
        no_verify_checks(gen, variant_lib, scale)
        mla_ptxas()
        width_sweep(gen, scale)
        width_sweep(gen, scale, heads=DS_HEADS, sfx="_h128")
        timed = [f for f in FOLDS if "folded_ms" in f]
        emit(phase="kernels", check="folded D / C / #4", widths=list(K.HEAD_WIDTHS),
             calls=len(FOLDS),
             mismatches=0, cases=sorted({f["case"] for f in FOLDS}),
             timed=len(timed), all_no_slower=all(f["no_slower"] for f in timed), times=timed)
        emit(phase="kernels_done", seconds=time.time() - t0)
        phase_autotune()

    # 3. one full-width layer, paged and contiguous (a counted main path)
    layer_launches = phase_layer()

    # 4. serve.generate on full mla-7b (a counted main path)
    serve_launches, base, params, prompts, serve_tps = phase_serve()

    # 4b. the same model through the collective-free region at world size 1
    phase_shard_map(base, params, prompts, smi)

    # 5. the serving engine on full mla-7b (counted main paths); then its
    # state off the card: E4 (host tier), E4 restartable, E5 (restartable,
    # traced, probed)
    t0 = time.time()
    kit, e1_tokens = phase_engine(base, params, serve_tps)
    emit(phase="engine_done", seconds=time.time() - t0)
    t0 = time.time()
    engine_launches = phase_engine_state(kit, params, e1_tokens)
    del kit                                     # its closures hold mla-7b's weights
    emit(phase="engine_state_done", seconds=time.time() - t0)

    # 6. every kernel of the paths launched in the main paths
    parts = (layer_launches, serve_launches, engine_launches)
    launches = {k: sum(x.get(k, 0) for x in parts) for k in set().union(*parts)}
    emit(phase="counts", layer=layer_launches, serve=serve_launches, engine=engine_launches)
    missing = [k for k in KERNELS if k not in OFF_PATH and k != "gqa_decode"
               and launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main paths: {missing}")

    # 7. where a step's time goes (after the counted main paths), in the
    # step loop and in the fused loop
    phase_profile(base, params, prompts)
    phase_profile_engine(gen, base, params, prompts)
    del params                                  # free mla-7b (22 GiB) for the next models
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the dense GQA family: #7 against its plain version, then serve on
    # full llama3.2-3b and the 6-layer full-width gemma3-27b (counted main
    # paths), one llama decode step profiled
    t0 = time.time()
    gqa_checks(gen, records)
    gqa_launches = {}
    for arch, layers, batch, plen, gsteps, fmts in GQA_SERVE + ENCODER_SERVE:
        if arch == ENCODER_SERVE[0][0]:
            emit(phase="gqa_done", seconds=time.time() - t0, launches=gqa_launches)
            t0 = time.time()           # 8b. the encoder families
        fused = arch in FUSED_SERVE
        got, g_base, g_params, g_prompts, g_aux = phase_gqa_serve(arch, layers, batch, plen,
                                                                  gsteps, fmts, fused=fused)
        gqa_launches[arch] = got
        if fused:
            phase_profile(g_base, g_params, g_prompts, runs=((False, 0, "fma"),),
                          match="gqa_decode_kernel" if got else None, aux=g_aux)
        del g_params, g_aux
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="encoder_done", seconds=time.time() - t0,
         launches={a: gqa_launches[a] for a, *_ in ENCODER_SERVE})
    for part in gqa_launches.values():
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v

    # 8c. the training path through its mesh of one: mla-7b (4 of 30 layers) and
    # whisper-base (full), 20 steps each, and a preempt-and-resume round
    t0 = time.time()
    phase_train(smi)
    emit(phase="train_done", seconds=time.time() - t0)

    # 8d. one dry-run cell, host only, in a subprocess
    t0 = time.time()
    phase_dryrun()
    emit(phase="dryrun_done", seconds=time.time() - t0)

    # 9. deepseek-v3-mla at full width, one layer: serve.generate and the
    # engine through the MLA kernels at 128 heads (counted main paths)
    t0 = time.time()
    ds_launches = phase_deepseek()
    emit(phase="deepseek_done", seconds=time.time() - t0, launches=ds_launches)
    for k, v in ds_launches.items():
        launches[k] = launches.get(k, 0) + v
    missing = [k for k in KERNELS if k not in OFF_PATH and launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main paths: {missing}")

    emit(phase="total", seconds=time.time() - t_start)
    print(summary_line(records, launches, sum(long_lens)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
