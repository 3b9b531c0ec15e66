#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

  1. build   — compile the hand-written kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel) and print the card's name and
               power limit as nvidia-smi gives them;
  2. kernels — every kernel of the serving path against its plain PyTorch
               version on the card: at the shapes the serving run gives it
               (mla-7b, batch 4, 5 pages) and at full MLA width over a ragged
               ~32k-token shuffled pool (fp8), plus int8 and none at a smaller
               shape; kernel median ms, plain ms and the bound ms;
  3. layer   — ``core.snapmla.decode_step``, one full-width layer over a
               ~32k-token pool: kernels vs the reference backend;
  4. serve   — ``launch.serve.generate`` on full mla-7b (30 layers, float32
               weights from a seeded generator), paged pool, batch 4, prompt
               512, gen 16: kernel backend with kv_splits 0 (single-pass kernel)
               and 4 (split-KV + combine) against the reference backend; the
               launch counters are reset just before and read just after the
               two kernel runs (the main path);
  5. counts  — every kernel of the path launched at least once;
  6. profile — one decode step of the serving run under torch.profiler: host
               wall, device kernel time, the device's idle share, top kernels.

The line before the last holds the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, without
a card or without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK = {"fp8_e4m3": 1979e12, "int8": 1979e12, "none": 989e12, "f32": 67e12}
PAGE, H, D_C, D_R = 128, 32, 512, 64
TOL = dict(rtol=1e-5, atol=1e-5)

SRC_DECODE = "src/repro_torch/csrc/mla_decode.cu"
SRC_QQUANT = "src/repro_torch/csrc/q_quant.cu"
KERNELS = {  # launch-counter name -> (source, the TPU kernel it replaces)
    "paged_splitkv_decode": (SRC_DECODE, "src/repro/kernels/mla_decode/kernel.py:794"),
    "paged_single_pass_decode": (SRC_DECODE, "src/repro/kernels/mla_decode/kernel.py:694"),
    "lse_combine": (SRC_DECODE, "src/repro/kernels/mla_decode/kernel.py:614"),
    "fused_q_quant": (SRC_QQUANT, "src/repro/kernels/quantize/kernel.py:50"),
}


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


def decode_bound(lens, fmt, splits, n_pages_table, heads=H, d_c=D_C, d_r=D_R):
    """Least time for one paged decode call: bytes the call must move (the
    live tokens' content, rope and scale, the query, the page table, the
    outputs) over HBM bandwidth vs its QK + PV operations at the format's
    tensor-core peak."""
    B = len(lens)
    esize = 2 if fmt == "none" else 1
    tokens = sum(lens)
    nbytes = (tokens * (d_c * esize + d_r * 2 + 4)
              + B * heads * (d_c * esize + d_r * 4 + 4)
              + B * (n_pages_table + 1) * 4
              + B * splits * heads * (d_c * 4 + 4 + (4 if splits > 1 else 0)))
    flops = tokens * heads * (2 * (d_c + d_r) + 2 * d_c)
    return _bound(nbytes, flops, PEAK[fmt])


def _bound(nbytes, flops, peak):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def make_case(gen, fmt, lens, P, *, extra=3, heads=H, d_c=D_C, d_r=D_R):
    """A random quantized shuffled page pool and a prepared query (on the card)."""
    import torch
    from repro_torch.core.kvcache import CacheConfig, PagedMLAPool, mla_quantize_entry
    from repro_torch.kernels.mla_decode.ref import prepare_q
    dev = "cuda"
    B = len(lens)
    n_pool = B * P + extra
    c = torch.randn(n_pool * PAGE, d_c, generator=gen, device=dev)
    r = torch.randn(n_pool * PAGE, d_r, generator=gen, device=dev) * 2
    content, rope, scale = mla_quantize_entry(CacheConfig(fmt=fmt, page_size=PAGE), c, r)
    table = torch.randperm(n_pool, generator=gen, device=dev)[: B * P]
    pool = PagedMLAPool(content.reshape(n_pool, PAGE, d_c).contiguous(),
                        rope.reshape(n_pool, PAGE, d_r).contiguous(),
                        scale.reshape(n_pool, PAGE).contiguous(),
                        table.reshape(B, P).to(torch.int32).contiguous(),
                        torch.tensor(lens, dtype=torch.int32, device=dev))
    q = prepare_q(torch.randn(B, heads, d_c, generator=gen, device=dev),
                  torch.randn(B, heads, d_r, generator=gen, device=dev), fmt)
    return tuple(t.contiguous() for t in q) + tuple(pool)


def kernel_checks(gen, fmt, lens, P, splits_list, scale, *, tag, timing, records):
    """A (each split count), B, C and (quantized formats) D against their
    plain versions on one case; with ``timing``, their times go to
    ``records[tag]``."""
    import torch
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode import ref as R
    from repro_torch.kernels.quantize import kernel as QK
    from repro_torch.kernels.quantize import ref as QR
    args = make_case(gen, fmt, lens, P)
    kw = dict(softmax_scale=scale, fmt=fmt)
    for S in splits_list:
        o, lse, (op, lp, sp) = K.mla_decode_paged_splitkv_cuda(*args, num_splits=S,
                                                               return_partials=True, **kw)
        o_r, lse_r, (op_r, lp_r, sp_r) = R.snapmla_decode_paged_splitkv_ref(
            *args, num_splits=S, return_partials=True, **kw)
        err = max(check_close(f"{tag} A S={S} o", o, o_r, **TOL),
                  check_close(f"{tag} A S={S} lse", lse, lse_r, **TOL),
                  check_close(f"{tag} A S={S} o_partial", op, op_r, **TOL),
                  check_close(f"{tag} A S={S} lse_partial", lp, lp_r, **TOL))
        check_close(f"{tag} A S={S} sigma_p", sp, sp_r, rtol=1e-6, atol=0.0)
        # C on these partials against its plain version
        oc, lc = K.lse_combine_cuda(op, lp)
        oc_r, lc_r = R.lse_combine_ref(op, lp)
        err_c = max(check_close(f"{tag} C S={S} o", oc, oc_r, **TOL),
                    check_close(f"{tag} C S={S} lse", lc, lc_r, **TOL))
        line = dict(phase="kernels", case=tag, fmt=fmt, kernel="A+C", splits=S,
                    max_abs_err_A=err, max_abs_err_C=err_c)
        if timing:
            ms_a = kernel_ms(lambda: K.paged_decode_partials_cuda(
                *args, num_splits=S, single_pass=False, **kw))
            plain_a = time_ms(lambda: R.snapmla_decode_paged_splitkv_ref(
                *args, num_splits=S, return_partials=True, **kw))
            bound_a = decode_bound(lens, fmt, S, P)
            ms_c = kernel_ms(lambda: K.lse_combine_cuda(op, lp))
            plain_c = time_ms(lambda: R.lse_combine_ref(op, lp))
            B = len(lens)
            bound_c = _bound(B * S * H * (D_C + 1) * 4 + B * H * (D_C + 1) * 4,
                             2 * B * S * H * D_C, PEAK["f32"])
            line.update(ms_A=ms_a, plain_ms_A=plain_a, bound_ms_A=bound_a[0],
                        ms_C=ms_c, plain_ms_C=plain_c, bound_ms_C=bound_c[0])
            records.setdefault(tag, {"tokens": sum(lens)})[("A", S)] = (
                err, ms_a, plain_a, bound_a)
            records[tag][("C", S)] = (err_c, ms_c, plain_c, bound_c)
        emit(**line)
    # B against the plain single-pass version (the empty row is NaN / -inf in both)
    o_b, lse_b = K.mla_decode_paged_cuda(*args, **kw)
    o_br, lse_br = R.snapmla_decode_paged_ref(*args, **kw)
    err_b = max(check_close(f"{tag} B o", o_b, o_br, equal_nan=True, **TOL),
                check_close(f"{tag} B lse", lse_b, lse_br, equal_nan=True, **TOL))
    # B against A at one split with every page live: bitwise
    P_ = args[6].shape[1]
    live = torch.full_like(args[7], P_ * PAGE)
    live[1:] -= torch.arange(1, len(lens), device="cuda", dtype=torch.int32) * 37 % PAGE
    args_live = args[:7] + (live,)
    o_l, lse_l = K.mla_decode_paged_cuda(*args_live, **kw)
    o_a1, lse_a1 = K.mla_decode_paged_splitkv_cuda(*args_live, num_splits=1, **kw)
    check_bitwise(f"{tag} B vs A(S=1) o", o_l, o_a1)
    check_bitwise(f"{tag} B vs A(S=1) lse", lse_l, lse_a1)
    line = dict(phase="kernels", case=tag, fmt=fmt, kernel="B", max_abs_err=err_b,
                bitwise_vs_A_one_split=True)
    if timing:
        ms_b = kernel_ms(lambda: K.mla_decode_paged_cuda(*args, **kw))
        plain_b = time_ms(lambda: R.snapmla_decode_paged_ref(*args, **kw))
        bound_b = decode_bound(lens, fmt, 1, P)
        line.update(ms=ms_b, plain_ms=plain_b, bound_ms=bound_b[0])
        records[tag][("B", 1)] = (err_b, ms_b, plain_b, bound_b)
    emit(**line)
    if fmt != "none":   # D: bit-identical to its plain version
        q = torch.randn(len(lens), H, D_C + D_R, generator=gen, device="cuda") * 3
        got, want = QK.fused_q_quant_cuda(q, D_C, fmt=fmt), QR.fused_q_quant_ref(q, D_C, fmt)
        for nm, g, w in zip(("q_c8", "q_r", "sigma_q"), got, want):
            check_bitwise(f"{tag} D {nm}", g, w)
        line = dict(phase="kernels", case=tag, fmt=fmt, kernel="D", bitwise=True)
        if timing:
            ms_d = kernel_ms(lambda: QK.fused_q_quant_cuda(q, D_C, fmt=fmt))
            plain_d = time_ms(lambda: QR.fused_q_quant_ref(q, D_C, fmt))
            B = len(lens)
            bound_d = _bound(B * H * ((D_C + D_R) * 4 + D_C + D_R * 4 + 4),
                             3 * B * H * (D_C + D_R), PEAK["f32"])
            line.update(ms=ms_d, plain_ms=plain_d, bound_ms=bound_d[0])
            records[tag][("D", 1)] = (0.0, ms_d, plain_d, bound_d)
        emit(**line)


def phase_layer(gen):
    """One full-width SnapMLA layer, decode_step over a ~32k-token pool."""
    import torch
    from repro_torch.core import mla as mla_lib
    from repro_torch.core import snapmla
    from repro_torch.core.kvcache import PagedMLAPool, paged_mla_prefill
    from repro_torch.kernels import _lib
    B, ctx = 4, 32760
    mcfg = mla_lib.MLAConfig(d_model=4096, n_heads=H, d_head=128, d_rope=D_R, d_c=D_C)
    cfg = snapmla.SnapMLAConfig(mla=mcfg)
    params = mla_lib.init_mla_params(gen, mcfg, device="cuda")
    pool = snapmla.init_cache(cfg, B, ctx + 8, device="cuda")
    pool = paged_mla_prefill(pool, cfg.cache,
                             torch.randn(B, ctx, D_C, generator=gen, device="cuda"),
                             torch.randn(B, ctx, D_R, generator=gen, device="cuda") * 2)
    h_t = torch.randn(B, 4096, generator=gen, device="cuda")
    ref_pool = PagedMLAPool(*(t.clone() for t in pool))
    before = dict(_lib.LAUNCHES)
    y, pool = snapmla.decode_step(params, cfg, h_t, pool)
    launched = {k: v - before.get(k, 0) for k, v in _lib.LAUNCHES.items()
                if v != before.get(k, 0)}
    y_ref, _ = snapmla.decode_step(params, dataclasses.replace(cfg, use_kernel=False),
                                   h_t, ref_pool)
    rel = float((y - y_ref).abs().max() / y_ref.abs().max())
    if not (torch.isfinite(y).all() and rel <= 1e-4):
        raise AssertionError(f"layer decode_step: relative error {rel} > 1e-4")
    emit(phase="layer", batch=B, context=ctx + 1, capacity=pool.capacity,
         rel_err_vs_ref=rel, kernels_launched=launched)


def phase_serve():
    """Full mla-7b through serve.generate: kernel backend vs reference."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    base = dataclasses.replace(get_config("mla-7b"), kv_paged=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    params = T.init_model(gen, base, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit(phase="serve_init", params=n_params, seconds=time.time() - t0,
         gib=torch.cuda.memory_allocated() / 2**30)
    prompts = torch.randint(0, base.vocab_size, (4, 512), generator=gen, device="cuda")

    def run(backend, splits):
        cfg = dataclasses.replace(base, kv_splits=splits, decode_backend=backend,
                                  use_kernels=backend == "kernel")
        return serve.generate(cfg, params, prompts, 16, return_logits=True)

    refs = {s: run("ref", s) for s in (0, 4)}
    _lib.reset_launches()                     # the main path starts here
    kern = {s: run("kernel", s) for s in (0, 4)}
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)            # ... and ends here
    for s in (0, 4):
        toks, tps, logits = kern[s]
        r_toks, r_tps, r_logits = refs[s]
        if not (torch.isfinite(logits).all() and torch.isfinite(r_logits).all()):
            raise AssertionError(f"serve kv_splits={s}: non-finite logits")
        # first decode step: the prefill is identical and each layer's
        # attention agrees to ~1e-6 (phase 3), but the next layer re-quantizes
        # its query and its new latent to fp8, where a one-ulp difference moves
        # a code by a whole fp8 step; over 30 random-weight layers that grows
        # to a few 1e-3 of the largest logit (measured: 2.7e-3, H100 run)
        first = float((logits[:, 1] - r_logits[:, 1]).abs().max()
                      / r_logits[:, 1].abs().max())
        if first > 1e-2:
            raise AssertionError(f"serve kv_splits={s}: first-step logits rel err {first}")
        if not torch.equal(toks[:, 0], r_toks[:, 0]):
            raise AssertionError(f"serve kv_splits={s}: prefill tokens differ")
        emit(phase="serve", arch="mla-7b", layers=base.n_layers, batch=4, prompt=512,
             gen=16, kv_splits=s, tok_per_s=tps, ref_tok_per_s=r_tps,
             greedy_agreement_vs_ref=float((toks == r_toks).float().mean()),
             first_step_logits_rel_err=first)
    return launches, base, params, prompts


def phase_profile(base, params, prompts):
    """Where one decode step's time goes (kernel backend, batch 4, context
    ~0.5k): host wall per step, device kernel time per step from
    torch.profiler, the device's idle share, and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    for splits in (0, 4):
        cfg = dataclasses.replace(base, kv_splits=splits, decode_backend="kernel",
                                  use_kernels=True)
        state = T.init_decode_state(cfg, 4, 640, device="cuda")
        logits, state = T.prefill(params, cfg, prompts, state)
        tok = logits.argmax(-1).to(torch.int32)

        def steps(first, n=3):
            nonlocal state
            for i in range(first, first + n):
                pos = torch.full((4,), 512 + i, dtype=torch.int32, device="cuda")
                _, state = T.decode_step(params, cfg, tok, state, pos)
            torch.cuda.synchronize()

        steps(0)
        t0 = time.perf_counter()
        steps(3)
        wall = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(6)
        rows = prof.key_averages()
        # device rows are the kernels and copies themselves, not the aten ops
        # that launched them (those carry the same time again)
        dev = sorted(((r.key, r.self_device_time_total / 3e3, r.count / 3) for r in rows
                      if r.self_device_time_total > 0 and not r.key.startswith("aten::")),
                     key=lambda x: -x[1])
        busy = sum(ms for _, ms, _ in dev)
        emit(phase="profile", kv_splits=splits, wall_ms_per_step=wall,
             device_ms_per_step=busy, device_idle_share=1.0 - busy / wall,
             aten_ops_per_step=sum(r.count for r in rows if r.key.startswith("aten::")) / 3,
             top=[(k[:80], round(ms, 4), n) for k, ms, n in dev[:8]])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the repository beside this file)
    from repro_torch.kernels import _lib

    # 1. build
    t0 = time.time()
    _lib.lib(verbose=True)
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
    kernel_checks(gen, "fp8_e4m3", [527, 512, 520, 513], 5, [4, 1], scale,
                  tag="serve_shape", timing=True, records=records)
    kernel_checks(gen, "fp8_e4m3", [0, PAGE, 32768, 20000], 256, [1, 4, 8], scale,
                  tag="long_32k", timing=True, records=records)
    for fmt in ("int8", "none"):
        kernel_checks(gen, fmt, [0, PAGE, 4000], 32, [1, 4], scale, tag=f"small_{fmt}",
                      timing=False, records=records)

    # 3. one full-width layer
    phase_layer(gen)

    # 4. the main path: serve.generate on full mla-7b
    launches, base, params, prompts = phase_serve()

    # 5. every kernel of the path launched in the main path
    emit(phase="counts", launches=launches)
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # 6. where a decode step's time goes (after the counted main path)
    phase_profile(base, params, prompts)

    shape = records["serve_shape"]
    longc = records["long_32k"]
    picks = {"paged_splitkv_decode": ("A", 4), "paged_single_pass_decode": ("B", 1),
             "lse_combine": ("C", 4), "fused_q_quant": ("D", 1)}
    long_picks = {"paged_splitkv_decode": ("A", 8), "paged_single_pass_decode": ("B", 1),
                  "lse_combine": ("C", 8), "fused_q_quant": ("D", 1)}
    summary = []
    for name, key in picks.items():
        err, ms, plain, (bound, by) = shape[key]
        l_err, l_ms, l_plain, (l_bound, l_by) = longc[long_picks[name]]
        summary.append(dict(
            name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
            launches=launches.get(name, 0), max_abs_err=max(err, l_err), ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None,
            long_ctx=dict(tokens=longc["tokens"], ms=l_ms, plain_ms=l_plain, bound_ms=l_bound,
                          bound_by=l_by)))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
