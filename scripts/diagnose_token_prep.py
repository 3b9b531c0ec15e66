#!/usr/bin/env python3
"""Where D's and #9's time goes, and what phase 3's layer gate compares, on
one NVIDIA GPU.

    python3 scripts/diagnose_token_prep.py variants
    python3 scripts/diagnose_token_prep.py widths
    python3 scripts/diagnose_token_prep.py layer [--seeds 0-3]
        [--offset-seed S --offsets LO:HI:STEP] [--layouts paged,contiguous]

``variants``: #9 (``csrc/k_append.cu``) built apart with one change each —
``no_seq_lens`` (the write row is the last, no load), ``multiply`` (each
quotient a product with sigma: the division's cost), ``no_loads`` (constant
values in place of the row's loads), ``sigma_only`` (sigma written, no
quotient taken, cast or stored) — and timed in turns with the unchanged
source (chip_smoke's ``kernel_ms``), at
batch 4 and 64, capacity 640, on entries with no all-zero row and on one
whose row 0 is all zero (``eps_row``); beside them D at 1 and 32 heads and
the launch floor (an in-place add on one element). The variants' bytes are
not the kernel's: they are for timing only.

``widths``: D (``csrc/q_quant.cu``) built with 1, 2, 4 and 8 rows (warps) per
block (``-DSNAPMLA_Q_ROWS``; the source's is 4), each held bitwise to the
plain version, then timed in turns three times over at chip_smoke's
``serve_shape`` (batch 4, 32 heads), ``serve_shape_h128`` (128 heads) and
``deepseek_b64`` (batch 64, 128 heads, L2 cold: ``chip_smoke.rotating``),
beside the launch floor.

``layer``: chip_smoke's phase 3 step (one full-width mla-7b layer, batch 4,
~32k tokens; ``chip_smoke.layer_inputs``), per random draw: the kernel
step's relative error against the parallel reference backend (phase 3's
gate) and against the kernels' plain version (the pipeline backends), the
two plain forms against each other, and phase 3's control (the reference on
h_t rounded to bfloat16). A draw is a seed (``--seeds 0,5-9``), or
``--offset-seed S --offsets LO:HI:STEP``: a generator seeded S whose Philox
offset is set to each of LO, LO + STEP, ... below HI (chip_smoke's main
generator after phase 2 is seed 1234 at some offset).

One JSON line per measurement, each with the card's name.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# variant -> {source text -> replacement} in k_append.cu and common.cuh
VARIANTS = {
    "no_seq_lens": ({"const int pos = seq_lens[b];": "const int pos = N - 1;"}, {}),
    "multiply": ({}, {"c[16 * s + 4 * k + e] / sig": "c[16 * s + 4 * k + e] * sig",
                      "r.x / sig, r.y / sig, r.z / sig, r.w / sig":
                      "r.x * sig, r.y * sig, r.z * sig, r.w * sig"}),
    "no_loads": ({"t.load(c_kv + static_cast<size_t>(b) * DC, k_r + static_cast<size_t>(b) * DR,"
                  " lane);": "for (int i = 0; i < Row::kC; ++i) t.c[i] = lane + i; "
                             "t.r = make_float4(1.f, 2.f, 3.f, 4.f);"}, {}),
    "sigma_only": ({"t.template store_content<F>(content + row * DC, sig, lane);": "",
                    "reinterpret_cast<uint2*>(rope + row * DR)[lane] = pack_bf16x4("
                    "t.rope_over(sig));": ""}, {}),
}


def emit(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


def build_variant(name: str, k_subs: dict, c_subs: dict) -> ctypes.CDLL:
    """k_append.cu with ``k_subs`` and its common.cuh with ``c_subs``,
    built by nvcc into ``build/token_prep_variants/<name>/``."""
    from repro_torch.kernels import _lib
    out = _lib.BUILD_DIR / "token_prep_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for fname, subs in (("k_append.cu", k_subs), ("common.cuh", c_subs)):
        text = (_lib.CSRC / fname).read_text()
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(out / "k_append.cu"), "-o",
                    str(out / "libk_append.so")], check=True)
    handle = ctypes.CDLL(str(out / "libk_append.so"))
    handle.snapmla_fused_k_append.argtypes = _lib._SIGNATURES["snapmla_fused_k_append"]
    handle.snapmla_fused_k_append.restype = ctypes.c_int
    return handle


def build_width(width: int) -> ctypes.CDLL:
    """q_quant.cu built with ``width`` rows per block into
    ``build/token_prep_widths/``."""
    from repro_torch.kernels import _lib
    out = _lib.BUILD_DIR / "token_prep_widths" / f"libq_quant_{width}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DSNAPMLA_Q_ROWS={width}", "-shared",
                    str(_lib.CSRC / "q_quant.cu"), "-o", str(out)], check=True)
    handle = ctypes.CDLL(str(out))
    handle.snapmla_fused_q_quant.argtypes = _lib._SIGNATURES["snapmla_fused_q_quant"]
    handle.snapmla_fused_q_quant.restype = ctypes.c_int
    return handle


def widths(device: str) -> None:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quantize import kernel as QK
    from repro_torch.kernels.quantize import ref as QR
    libs = {w: build_width(w) for w in (1, 2, 4, 8)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {"serve_shape": (4, CS.H), "serve_shape_h128": (4, CS.DS_HEADS),
             "deepseek_b64": (64, CS.DS_HEADS)}
    inputs = {tag: [torch.randn(B, h, CS.D_C + CS.D_R, generator=gen, device="cuda") * 3
                    for _ in range(3)] for tag, (B, h) in cases.items()}
    for w, handle in libs.items():
        with _lib.using(handle):
            for tag, ins in inputs.items():
                for g, x in zip(QK.fused_q_quant_cuda(ins[0], CS.D_C),
                                QR.fused_q_quant_ref(ins[0], CS.D_C, "fp8_e4m3")):
                    CS.check_bitwise(f"D {tag} rows per block {w}", g, x)
    floor = torch.zeros(1, device="cuda")
    ms: dict = {}
    for _ in range(3):                      # in turns: every width once per round
        for tag, ins in inputs.items():
            for w, handle in libs.items():
                keep: list = []
                fn = (CS.rotating(ins, lambda q: QK.fused_q_quant_cuda(q, CS.D_C), keep)
                      if tag == "deepseek_b64"
                      else lambda q=ins[0]: QK.fused_q_quant_cuda(q, CS.D_C))
                with _lib.using(handle):
                    ms.setdefault(f"{tag} {w}", []).append(CS.kernel_ms(fn))
        ms.setdefault("launch_floor", []).append(CS.kernel_ms(lambda: floor.add_(1.0)))
    emit(measure="D rows per block", bitwise=True, ms=ms, device=device)


def variants(device: str) -> None:
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quantize import kernel as QK
    libs = {"base": None} | {n: build_variant(n, *subs) for n, subs in VARIANTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for B, N in ((4, 640), (64, 640)):
        cache = (torch.zeros(B, N, 512, dtype=torch.uint8, device="cuda").view(
                     torch.float8_e4m3fn),
                 torch.zeros(B, N, 64, dtype=torch.bfloat16, device="cuda"),
                 torch.zeros(B, N, device="cuda"))
        c = torch.randn(B, 512, generator=gen, device="cuda") * 3
        r = torch.randn(B, 64, generator=gen, device="cuda") * 10
        c0 = c.clone()
        c0[0] = 0.0
        lens = torch.randint(0, N, (B,), generator=gen, device="cuda", dtype=torch.int32)
        qs = {h: torch.randn(B, h, 576, generator=gen, device="cuda") for h in (1, 32)}
        floor = torch.zeros(1, device="cuda")
        ms: dict = {}
        for _ in range(2):                      # in turns: every call once, twice over
            for name, handle in libs.items():
                with _lib.using(handle) if handle else contextlib.nullcontext():
                    for tag, cc in (("", c), (" eps_row", c0)):
                        ms.setdefault(name + tag, []).append(CS.kernel_ms(
                            lambda cc=cc: QK.fused_k_append_cuda(*cache, cc, r, lens)))
            for h, q in qs.items():
                ms.setdefault(f"D {h} heads", []).append(CS.kernel_ms(
                    lambda q=q: QK.fused_q_quant_cuda(q, 512)))
            ms.setdefault("launch_floor", []).append(CS.kernel_ms(lambda: floor.add_(1.0)))
        emit(measure="#9 variants", batch=B, capacity=N, ms=ms, device=device)


@contextlib.contextmanager
def pipeline_backend():
    """decode_step with use_kernel=False decodes through the kernels' plain
    version (the pipeline backends) in place of the parallel reference."""
    from repro_torch.kernels.mla_decode import backends
    resolve = backends.resolve_backend

    def pipeline(request="auto", *, paged=False, **kw):
        if request == "ref":
            request = "torch_paged_pipeline" if paged else "torch_pipeline"
        return resolve(request, paged=paged, **kw)
    backends.resolve_backend = pipeline
    try:
        yield
    finally:
        backends.resolve_backend = resolve


def layer(gen, draw: dict, layouts, device: str) -> None:
    """chip_smoke.phase_layer's step on ``gen``'s draw, measured as the
    module docstring says."""
    import torch
    from repro_torch.core import snapmla
    import chip_smoke as CS
    mcfg, params, c, r, h_t = CS.layer_inputs(gen)
    for paged in layouts:
        cfg = snapmla.SnapMLAConfig(mla=mcfg, paged=paged)
        cache = CS.layer_cache(cfg, c, r)

        def step(config, h=h_t):
            copy = type(cache)(*(None if t is None else t.clone() for t in cache))
            return snapmla.decode_step(params, config, h, copy)[0]
        y = step(cfg)
        ref_cfg = dataclasses.replace(cfg, use_kernel=False)
        y_ref = step(ref_cfg)
        with pipeline_backend():
            y_plain = step(ref_cfg)
        y_ctl = step(ref_cfg, h_t.bfloat16().float())
        emit(measure="layer", **draw, paged=paged, rel_kernel_vs_ref=CS.rel_err(y, y_ref),
             rel_kernel_vs_plain=CS.rel_err(y, y_plain),
             rel_plain_vs_ref=CS.rel_err(y_plain, y_ref),
             rel_control_vs_ref=CS.rel_err(y_ctl, y_ref), finite=bool(torch.isfinite(y).all()),
             device=device)
        del cache


def _ints(spec: str) -> list[int]:
    out = []
    for part in filter(None, spec.split(",")):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("variants", "widths", "layer"))
    ap.add_argument("--seeds", default="", help="e.g. 0-3,7")
    ap.add_argument("--offset-seed", type=int, default=None)
    ap.add_argument("--offsets", default="", help="LO:HI:STEP")
    ap.add_argument("--layouts", default="paged,contiguous")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diagnose_token_prep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.cuda.get_device_name(0)
    if args.what in ("variants", "widths"):
        (variants if args.what == "variants" else widths)(device)
        return 0
    layouts = [{"paged": True, "contiguous": False}[x] for x in args.layouts.split(",")]
    for seed in _ints(args.seeds):
        layer(torch.Generator(device="cuda").manual_seed(seed), {"seed": seed}, layouts, device)
    if args.offsets:
        lo, hi, step = map(int, args.offsets.split(":"))
        for offset in range(lo, hi, step):
            gen = torch.Generator(device="cuda").manual_seed(args.offset_seed)
            gen.set_offset(offset)
            layer(gen, {"seed": args.offset_seed, "offset": offset}, layouts, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
