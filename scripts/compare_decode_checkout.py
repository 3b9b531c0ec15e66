#!/usr/bin/env python3
"""Hold this checkout's MLA decode launches against another checkout's
``mla_decode.cu`` on one NVIDIA GPU, bit for bit, at chip_smoke.py's MLA
cases (FMA).

    python3 scripts/compare_decode_checkout.py OTHER_CHECKOUT

OTHER_CHECKOUT is a checkout (``git archive`` of a commit) whose
``src/repro_torch/csrc/mla_decode.cu`` takes the prepared query only and
leaves the combine to the standalone C kernel (its ``snapmla_decode`` has the
argument list of ``OTHER_DECODE_ARGS``). The script builds that source, with
its own ``common.cuh``, by nvcc into ``build/other_mla_decode_<hash>.so`` and,
on each case, split count and layout:

  * ``c``: this checkout's standalone C against the other's standalone C on
    the same partials (the other kernel's);
  * ``partials``: this checkout's unfolded decode kernel against the other's
    on the same prepared query (o, lse and sigma_p partials);
  * ``folded``: this checkout's folded launch — the raw query, quantized in
    the kernel's prologue (D), the partials merged in its epilogue (C) —
    against D (this checkout's; its source is unchanged), the other's kernel
    and the other's C; in single pass, against D and the other's kernel.

Each count is the number of 32-bit words that differ. Then, on the paged
pool at the split counts of ``TIMED``, device ms (chip_smoke's ``kernel_ms``:
CUDA-graph replays, L2-warm) of the other kernel and of this one on the
prepared query (``other_kernel_ms``, ``kernel_ms``), and of the other
checkout's launches D, kernel, C (D, kernel in single pass; D, kernel, #4
under AMLA) against this checkout's folded call (``other_chain_ms``,
``folded_ms``), the two checkouts timed in turns (other, this, this, other).
Prints one JSON line per case, one per timed case and a total line; exits
non-zero on any mismatch.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# fmt, single_pass, amla, q_c8, q_r, sigma_q, content, rope, scale,
# page_table, seq_lens, sink, S_k, o_part, lse_part, sp_part, B, H, d_c, d_r,
# block, P, num_splits, blocks_per_split, softmax_scale, q_len, width, stream
OTHER_DECODE_ARGS = [_I] * 3 + [_P] * 9 + [_I] + [_P] * 3 + [_I] * 8 + [_F, _I, _I, _P]
# o_part, lse_part, o, lse, B, S, H, d_c, stream
OTHER_COMBINE_ARGS = [_P] * 4 + [_I] * 4 + [_P]
LONG = [0, 128, 32768, 20000]
SERVE = [527, 512, 520, 513]
# chip_smoke.py's MLA cases: (tag, fmt, lens, pages, q_len, splits, sink rows)
CASES = [("serve_shape", "fp8_e4m3", SERVE, 5, 1, (4, 1), 0),
         ("long_32k", "fp8_e4m3", LONG, 256, 1, (1, 4, 8), 0),
         ("sink", "fp8_e4m3", SERVE, 5, 1, (4, 1), 4),
         ("small_int8", "int8", [0, 128, 4000], 32, 1, (1, 4), 0),
         ("small_none", "none", [0, 128, 4000], 32, 1, (1, 4), 0),
         ("verify_shape", "fp8_e4m3", [3, 512, 777, 1100], 9, 5, (1, 4, 8), 0),
         ("long_32k_verify", "fp8_e4m3", LONG, 256, 4, (1, 4, 8), 0)]
# (case, split count) timed; 0 splits: the single pass
TIMED = {("serve_shape", 4), ("serve_shape", 0), ("long_32k", 8), ("verify_shape", 1),
         ("verify_shape", 8), ("long_32k_verify", 8)}


def build_other(other: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _lib
    csrc = other / "src" / "repro_torch" / "csrc"
    src = (csrc / "mla_decode.cu").read_bytes() + (csrc / "common.cuh").read_bytes()
    out = _lib.BUILD_DIR / f"other_mla_decode_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not out.exists():
        _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(csrc),
                        str(csrc / "mla_decode.cu"), "-o", str(out)], check=True)
    handle = ctypes.CDLL(str(out))
    handle.snapmla_decode.argtypes = OTHER_DECODE_ARGS
    handle.snapmla_lse_combine.argtypes = OTHER_COMBINE_ARGS
    handle.snapmla_amla_combine.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    for fn in (handle.snapmla_decode, handle.snapmla_lse_combine, handle.snapmla_amla_combine):
        fn.restype = ctypes.c_int
    return handle


def mismatches(a, b) -> int:
    import torch
    a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a != b).sum())


def other_decode(other, fmt, single_pass, q, cache_args, page_table, sink, *, B, R, S, P,
                 q_len, scale, amla=False):
    """The other checkout's kernel on a prepared query of R rows: its partials."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    from chip_smoke import D_C, D_R, PAGE
    o_p = torch.empty((B, S, R, D_C), dtype=torch.float32, device="cuda")
    lse_p = torch.empty((B, S, R), dtype=torch.float32, device="cuda")
    sp_p = None if single_pass else torch.empty_like(lse_p)
    content, rope, scale_t, seq_lens = cache_args
    rc = other.snapmla_decode(
        K.FMT_CODES[fmt], int(single_pass), int(amla), q[0].data_ptr(), q[1].data_ptr(),
        q[2].data_ptr(), content.data_ptr(), rope.data_ptr(), scale_t.data_ptr(),
        None if page_table is None else page_table.data_ptr(), seq_lens.data_ptr(),
        None if sink is None else sink.data_ptr(), 0 if sink is None else sink.shape[1],
        o_p.data_ptr(), lse_p.data_ptr(), None if sp_p is None else sp_p.data_ptr(),
        B, R, D_C, D_R, PAGE, P, S, -(-P // S), float(scale), q_len,
        K.head_width(B, R, S, _lib.sm_count(0)), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the other checkout's snapmla_decode failed: {rc}")
    return o_p, lse_p, sp_p


def other_combine(other, o_p, lse_p):
    import torch
    B, S, R, d_c = o_p.shape
    o = torch.empty((B, R, d_c), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, R), dtype=torch.float32, device="cuda")
    rc = other.snapmla_lse_combine(o_p.data_ptr(), lse_p.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), B, S, R, d_c,
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the other checkout's snapmla_lse_combine failed: {rc}")
    return o, lse


def other_amla_combine(other, acc, l, g):
    import torch
    B, S, R, d_c = acc.shape
    o = torch.empty((B, R, d_c), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, R), dtype=torch.float32, device="cuda")
    rc = other.snapmla_amla_combine(acc.data_ptr(), l.data_ptr(), g.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), B, S, R, d_c,
                                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the other checkout's snapmla_amla_combine failed: {rc}")
    return o, lse


def time_pair(other_fns: dict, this_fns: dict) -> dict:
    """Device ms of each call, the two checkouts in turns (other, this,
    this, other), the mean of the two turns of each."""
    from chip_smoke import kernel_ms
    out = {k: [] for k in list(other_fns) + list(this_fns)}
    for first, second in ((other_fns, this_fns), (this_fns, other_fns)):
        for fns in (first, second):
            for k, fn in fns.items():
                out[k].append(kernel_ms(fn))
    return {k: sum(v) / len(v) for k, v in out.items()}


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_decode_checkout: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode.ref import prepare_q
    other = build_other(Path(sys.argv[1]).resolve())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    scale = 1.0 / (128 + CS.D_R) ** 0.5
    total = {"c": 0, "partials": 0, "folded": 0}
    for tag, fmt, lens, P, q_len, splits, sink_rows in CASES:
        q, cache, pool, raw = CS.make_case(gen, fmt, lens, P, sink_tokens=sink_rows)
        if q_len > 1:
            q, raw = CS.verify_query(gen, len(lens), q_len, fmt)
        B, R = len(lens), q_len * CS.H
        flat_raw = tuple(t.reshape(B, R, -1).contiguous() for t in raw)
        prepared = (tuple(t.reshape(B, R, *t.shape[3:]).contiguous() for t in q)
                    if q_len > 1 else q)
        if fmt != "none":        # the unfolded query: D as its own launch
            prepared = CS.d_query(flat_raw, fmt)
        elif q_len == 1:
            prepared = tuple(t.contiguous() for t in prepare_q(*raw, fmt))
        fq = prepared if fmt == "none" else tuple(raw) + (None,)   # rank 4 in verify
        layouts = [("contiguous", (cache.content, cache.rope, cache.scale, cache.seq_lens),
                    None, cache.sink)]
        if not sink_rows:
            layouts.append(("paged", (pool.content, pool.rope, pool.scale, pool.seq_lens),
                            pool.page_table, None))
        counts = {"c": 0, "partials": 0, "folded": 0}
        kw = dict(softmax_scale=scale, fmt=fmt)
        for layout, cache_args, table, sink in layouts:
            content, rope, sc, lens_t = cache_args
            new_cache = ((content, rope, sc, table, lens_t) if table is not None
                         else (content, rope, sc, lens_t))
            new_kw = dict(kw) if table is not None else dict(kw, block_n=CS.PAGE, sink=sink)
            split_call = (K.mla_decode_paged_splitkv_cuda if table is not None
                          else K.mla_decode_splitkv_cuda)
            parts_call = (K.paged_decode_partials_cuda if table is not None
                          else K.decode_partials_cuda)
            dims = dict(B=B, R=R, P=P, q_len=q_len, scale=scale)
            for S in splits:
                theirs = other_decode(other, fmt, False, prepared, cache_args, table, sink, S=S,
                                      **dims)
                o_c, l_c = other_combine(other, *theirs[:2])
                mine_c = K.lse_combine_cuda(*theirs[:2])
                counts["c"] += mismatches(mine_c[0], o_c) + mismatches(mine_c[1], l_c)
                mine_p = parts_call(*prepared, *new_cache, num_splits=S, single_pass=False,
                                    q_len=q_len, **new_kw)
                counts["partials"] += sum(mismatches(a, b) for a, b in zip(mine_p, theirs))
                o, lse = split_call(*fq, *new_cache, num_splits=S, **new_kw)
                counts["folded"] += (mismatches(o.reshape(B, R, -1), o_c)
                                     + mismatches(lse.reshape(B, R), l_c))
            if q_len == 1 and fmt != "none":   # single pass: D in the prologue of B / #1
                theirs = other_decode(other, fmt, True, prepared, cache_args, table, sink, S=1,
                                      **dims)
                single = (K.mla_decode_paged_cuda if table is not None else K.mla_decode_cuda)
                o, lse = single(*fq, *new_cache, **new_kw)
                counts["folded"] += mismatches(o, theirs[0][:, 0]) + mismatches(lse,
                                                                                theirs[1][:, 0])
            if table is None or fmt == "none":
                continue
            flat = CS.d_input(flat_raw)
            for S in [s for s in (0,) + tuple(splits) if (tag, s) in TIMED]:
                for rescale in ("fma", "amla"):
                    kw_r = dict(new_kw, rescale=rescale)
                    amla = rescale == "amla"

                    def chain(S=S, amla=amla):
                        qd = CS.d_query(flat_raw, fmt, flat)
                        parts = other_decode(other, fmt, S == 0, qd, cache_args, table, sink,
                                             S=max(S, 1), amla=amla, **dims)
                        if S == 0:
                            return parts
                        return (other_amla_combine(other, *parts) if amla
                                else other_combine(other, *parts[:2]))

                    if S == 0:
                        this = {"kernel_ms": lambda kw_r=kw_r: parts_call(
                                    *prepared, *new_cache, num_splits=1, single_pass=True,
                                    **kw_r),
                                "folded_ms": lambda kw_r=kw_r: K.mla_decode_paged_cuda(
                                    *fq, *new_cache, **kw_r)}
                    else:
                        this = {"kernel_ms": lambda S=S, kw_r=kw_r: parts_call(
                                    *prepared, *new_cache, num_splits=S, single_pass=False,
                                    q_len=q_len, **kw_r),
                                "folded_ms": lambda S=S, kw_r=kw_r: split_call(
                                    *fq, *new_cache, num_splits=S, **kw_r)}
                    theirs_fns = {"other_kernel_ms": lambda S=S, amla=amla: other_decode(
                                      other, fmt, S == 0, prepared, cache_args, table, sink,
                                      S=max(S, 1), amla=amla, **dims),
                                  "other_chain_ms": chain}
                    t = time_pair(theirs_fns, this)
                    print(json.dumps(dict(case=tag, splits=S or "single pass", rescale=rescale,
                                          layout=layout, **t,
                                          device=torch.cuda.get_device_name(0))), flush=True)
        torch.cuda.synchronize()
        for k, v in counts.items():
            total[k] += v
        print(json.dumps(dict(case=tag, fmt=fmt, q_len=q_len, splits=list(splits),
                              layouts=[x[0] for x in layouts], mismatches=counts)), flush=True)
    print(json.dumps(dict(check="this checkout vs the other mla_decode.cu", mismatches=total,
                          device=torch.cuda.get_device_name(0))), flush=True)
    return 1 if any(total.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
