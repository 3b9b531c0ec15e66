#!/usr/bin/env python3
"""Hold this checkout's MLA decode launches and its fused fetch-dequant (K1)
against another checkout's ``mla_decode.cu`` and ``fetch_dequant.cu`` on one
NVIDIA GPU, bit for bit, at chip_smoke.py's cases, both rescale modes.

    python3 scripts/compare_decode_checkout.py OTHER_CHECKOUT

OTHER_CHECKOUT is a checkout (``git archive`` of a commit) whose
``src/repro_torch/csrc/mla_decode.cu`` has this checkout's ``snapmla_decode``
argument list (the raw query and the folded outputs may stay nullptr: the
script hands it the prepared query and leaves the merge to its standalone C
and #4) and whose ``fetch_dequant.cu`` has the argument list of
``OTHER_FETCH_ARGS``. The script builds each of the two sources, with its
own ``common.cuh``, by nvcc into ``build/other_<source>_<hash>.so`` with
ptxas's report and, on each case, split count and layout, FMA and AMLA:

  * ``c`` / ``m4``: this checkout's standalone C / #4 against the other's on
    the same partials (the other kernel's);
  * ``partials``: this checkout's unfolded decode kernel against the other's
    on the same prepared query (o, lse and sigma_p partials; AMLA: acc, l, g);
  * ``folded``: this checkout's folded launch — the raw query, quantized in
    the kernel's prologue (D), the partials merged in its epilogue (C or #4)
    — against D (this checkout's; its source is unchanged), the other's
    kernel and the other's C or #4; in single pass, against D and the
    other's kernel;
  * ``fetch``: K1 paged in full and bounded mode and its contiguous mode
    (#10) against the other's, at the engine's shape, at ~32k and at small
    int8 and bf16 caches.

Each count is the number of 32-bit words that differ (16-bit for K1's bf16
output). Then device ms (chip_smoke's ``kernel_ms``: CUDA-graph replays,
L2-warm), the two checkouts timed in turns (other, this, this, other): on
the paged pool at the split counts of ``TIMED``, the other kernel and this
one on the prepared query (``other_kernel_ms``, ``kernel_ms``), and the
other checkout's launches D, kernel, C or #4 (D, kernel in single pass)
against this checkout's folded call (``other_chain_ms``, ``folded_ms``); the
standalone #4 on the same partials; K1 bounded and #10 at the engine's shape
and at ~32k. Last, each MLA decode instantiation's registers and spill bytes
in both builds: an AMLA split instantiation that spills more than the
other's, a width-1 instantiation past 64 registers where the other's was
within (two blocks of 512 threads per SM), or a K1 spill fails. Prints one
JSON line per case, per timed case and per check, and a total line; exits
non-zero on any mismatch or failed check.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_P, _I = ctypes.c_void_p, ctypes.c_int
# fmt, content, rope, scale, page_table, chunk_start, out, B, P, page, d_c,
# d_r, stream (the fetch kernel before its launch took tokens per warp)
OTHER_FETCH_ARGS = [_I] + [_P] * 6 + [_I] * 5 + [_P]
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
# K1's cases: (tag, fmt, lens, pages, chunk_start, timed)
FETCH_CASES = [("engine_shape", "fp8_e4m3", [1000], 8, [768], True),
               ("long_32k", "fp8_e4m3", LONG, 256, [0, 1000, 20000, 32768], True),
               ("small_int8", "int8", [0, 128, 4000], 32, [0, 100, 3000], False),
               ("small_none", "none", [0, 128, 4000], 32, [4000, 1, 129], False)]


def build_other(other: Path, source: str) -> tuple[ctypes.CDLL, str]:
    """The other checkout's ``source`` built into its own library (with its
    own common.cuh); returns the handle and ptxas's report."""
    from repro_torch.kernels import _lib
    csrc = other / "src" / "repro_torch" / "csrc"
    src = (csrc / source).read_bytes() + (csrc / "common.cuh").read_bytes()
    out = _lib.BUILD_DIR / f"other_{Path(source).stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if not (out.exists() and log_path.exists()):
        _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
                               str(csrc), str(csrc / source), "-o", str(out)],
                              capture_output=True, text=True, check=True)
        log_path.write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(out)), log_path.read_text()


def mismatches(a, b) -> int:
    import torch
    view = torch.int16 if a.element_size() == 2 else torch.int32
    a, b = a.contiguous().view(view), b.contiguous().view(view)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a != b).sum())


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


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
        q[2].data_ptr(), None, None, content.data_ptr(), rope.data_ptr(), scale_t.data_ptr(),
        None if page_table is None else page_table.data_ptr(), seq_lens.data_ptr(),
        None if sink is None else sink.data_ptr(), 0 if sink is None else sink.shape[1],
        o_p.data_ptr(), lse_p.data_ptr(), None if sp_p is None else sp_p.data_ptr(), None, None,
        None, B, R, D_C, D_R, PAGE, P, S, -(-P // S), float(scale), q_len,
        K.head_width(B, R, S, _lib.sm_count(0)), _stream())
    if rc:
        raise RuntimeError(f"the other checkout's snapmla_decode failed: {rc}")
    return o_p, lse_p, sp_p


def other_combine(other, parts, amla):
    """The other checkout's standalone C (FMA) or #4 (AMLA) on raw partials."""
    import torch
    B, S, R, d_c = parts[0].shape
    o = torch.empty((B, R, d_c), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, R), dtype=torch.float32, device="cuda")
    if amla:
        rc = other.snapmla_amla_combine(*(t.data_ptr() for t in parts), o.data_ptr(),
                                        lse.data_ptr(), B, S, R, d_c, _stream())
    else:
        rc = other.snapmla_lse_combine(parts[0].data_ptr(), parts[1].data_ptr(), o.data_ptr(),
                                       lse.data_ptr(), B, S, R, d_c, _stream())
    if rc:
        raise RuntimeError(f"the other checkout's combine failed: {rc}")
    return o, lse


def other_fetch(other, content, rope, scale, page_table, chunk_start, *, B, P, page):
    import torch
    from repro_torch.kernels.quantize import fetch_dequant as FD
    d_c, d_r = content.shape[-1], rope.shape[-1]
    out = torch.empty((B, P * page, d_c + d_r), dtype=torch.bfloat16, device="cuda")
    rc = other.snapmla_fetch_dequant(
        FD.FMT_CODES[content.dtype], content.data_ptr(), rope.data_ptr(), scale.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        None if chunk_start is None else chunk_start.data_ptr(), out.data_ptr(), B, P, page,
        d_c, d_r, _stream())
    if rc:
        raise RuntimeError(f"the other checkout's snapmla_fetch_dequant failed: {rc}")
    return out


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


def decode_cases(other, gen, scale, device) -> dict:
    """Every MLA case against the other's decode, C and #4: the counts."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels.mla_decode import kernel as K
    from repro_torch.kernels.mla_decode.ref import prepare_q
    total = {"c": 0, "m4": 0, "partials": 0, "folded": 0}
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
        counts = dict.fromkeys(total, 0)
        for layout, cache_args, table, sink in layouts:
            content, rope, sc, lens_t = cache_args
            new_cache = ((content, rope, sc, table, lens_t) if table is not None
                         else (content, rope, sc, lens_t))
            new_kw = (dict(softmax_scale=scale, fmt=fmt) if table is not None
                      else dict(softmax_scale=scale, fmt=fmt, block_n=CS.PAGE, sink=sink))
            split_call = (K.mla_decode_paged_splitkv_cuda if table is not None
                          else K.mla_decode_splitkv_cuda)
            parts_call = (K.paged_decode_partials_cuda if table is not None
                          else K.decode_partials_cuda)
            dims = dict(B=B, R=R, P=P, q_len=q_len, scale=scale)
            for rescale in ("fma", "amla"):
                amla = rescale == "amla"
                kw_r = dict(new_kw, rescale=rescale)
                for S in splits:
                    theirs = other_decode(other, fmt, False, prepared, cache_args, table, sink,
                                          S=S, amla=amla, **dims)
                    o_c, l_c = other_combine(other, theirs if amla else theirs[:2], amla)
                    mine_c = K.combine_cuda(theirs, rescale)
                    counts["m4" if amla else "c"] += (mismatches(mine_c[0], o_c)
                                                      + mismatches(mine_c[1], l_c))
                    mine_p = parts_call(*prepared, *new_cache, num_splits=S, single_pass=False,
                                        q_len=q_len, **kw_r)
                    counts["partials"] += sum(mismatches(a, b) for a, b in zip(mine_p, theirs))
                    o, lse = split_call(*fq, *new_cache, num_splits=S, **kw_r)
                    counts["folded"] += (mismatches(o.reshape(B, R, -1), o_c)
                                         + mismatches(lse.reshape(B, R), l_c))
                if q_len == 1 and fmt != "none":   # single pass: D in the prologue of B / #1
                    theirs = other_decode(other, fmt, True, prepared, cache_args, table, sink,
                                          S=1, amla=amla, **dims)
                    single = (K.mla_decode_paged_cuda if table is not None
                              else K.mla_decode_cuda)
                    o, lse = single(*fq, *new_cache, **kw_r)
                    counts["folded"] += (mismatches(o, theirs[0][:, 0])
                                         + mismatches(lse, theirs[1][:, 0]))
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
                        return other_combine(other, parts if amla else parts[:2], amla)

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
                    if amla and S > 1:   # the standalone #4 on the same partials
                        parts = other_decode(other, fmt, False, prepared, cache_args, table,
                                             sink, S=S, amla=True, **dims)
                        this["m4_ms"] = lambda p=parts: K.amla_combine_cuda(*p)
                        theirs_fns["other_m4_ms"] = lambda p=parts: other_combine(other, p, True)
                    t = time_pair(theirs_fns, this)
                    print(json.dumps(dict(case=tag, splits=S or "single pass", rescale=rescale,
                                          layout=layout, **t, device=device)), flush=True)
        torch.cuda.synchronize()
        for k, v in counts.items():
            total[k] += v
        print(json.dumps(dict(case=tag, fmt=fmt, q_len=q_len, splits=list(splits),
                              layouts=[x[0] for x in layouts], mismatches=counts)), flush=True)
    return total


def fetch_cases(other, gen, device) -> int:
    """K1 and #10 against the other's fetch: the count; ms in turns."""
    import contextlib
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quantize import fetch_dequant as FD
    total = 0
    for tag, fmt, lens, P, starts, timed in FETCH_CASES:
        _, cache, pool, _ = CS.make_case(gen, fmt, lens, P)
        cs = torch.tensor(starts, dtype=torch.int32, device="cuda")
        B = len(lens)
        pool_args = (pool.content, pool.rope, pool.scale, pool.page_table)
        dims = dict(B=B, P=P, page=CS.PAGE)
        theirs = {"full": other_fetch(other, *pool_args, None, **dims),
                  "bounded": other_fetch(other, *pool_args, cs, **dims),
                  "contiguous": other_fetch(other, cache.content, cache.rope, cache.scale, None,
                                            None, **dims)}
        count = 0
        for tpw in (None,) + FD.TOKENS_PER_WARP:
            with FD.forced_tokens_per_warp(tpw) if tpw else contextlib.nullcontext():
                count += (mismatches(FD.paged_fetch_dequant(pool), theirs["full"])
                          + mismatches(FD.paged_fetch_dequant(pool, chunk_start=cs),
                                       theirs["bounded"])
                          + mismatches(FD.fetch_dequant(cache, page=CS.PAGE),
                                       theirs["contiguous"]))
        total += count
        line = dict(case=tag, kernel="fetch_dequant", fmt=fmt, lens=lens, pages=P,
                    chunk_start=starts, tokens_per_warp=FD.fetch_geometry(
                        B, P, CS.PAGE, _lib.sm_count(0))[0], mismatches=count)
        if timed:
            line.update(time_pair(
                {"other_bounded_ms": lambda: other_fetch(other, *pool_args, cs, **dims),
                 "other_contiguous_ms": lambda: other_fetch(
                     other, cache.content, cache.rope, cache.scale, None, None, **dims)},
                {"bounded_ms": lambda: FD.paged_fetch_dequant(pool, chunk_start=cs),
                 "contiguous_ms": lambda: FD.fetch_dequant(cache, page=CS.PAGE)}),
                device=device)
        print(json.dumps(line), flush=True)
    return total


def ptxas_rows(log: str) -> dict:
    """Entry -> (registers, spill bytes, callees' included) of every MLA
    decode instantiation (key: fmt width single_pass amla sink verify) and
    K1 (key: fetch fmt), from chip_smoke's parser of the ptxas report."""
    from chip_smoke import ptxas_entries
    rows = {}
    for name, row in ptxas_entries(log).items():
        m = re.search(r"decode_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
        f = re.search(r"fetch_dequant_kernelILi(\d)E", name)
        if m or f:
            rows[" ".join(m.groups()) if m else f"fetch {f.group(1)}"] = row
    return rows


def ptxas_check(this_log: str, other_log: str) -> list:
    """The register and spill gates of the module docstring; returns the
    failures and prints both builds' rows."""
    this, theirs = ptxas_rows(this_log), ptxas_rows(other_log)
    bad = []
    for key, (regs, spill) in this.items():
        if key.startswith("fetch"):
            if spill:
                bad.append(f"K1 fmt {key[6:]} spills {spill} bytes")
            continue
        fmt, width, single, amla, sink, verify = key.split()
        old = theirs.get(key)
        if old is None:
            bad.append(f"no ptxas row of {key} in the other build")
            continue
        if amla == "1" and single == "0" and spill > old[1]:
            bad.append(f"AMLA split {key} spills {spill} bytes (other: {old[1]})")
        if width == "1" and old[0] <= 64 < regs:
            bad.append(f"width-1 {key} uses {regs} registers (other: {old[0]})")
    print(json.dumps(dict(check="ptxas", key="fmt width single_pass amla sink verify -> "
                          "[registers, spill bytes]", this=this, other=theirs, failures=bad)),
          flush=True)
    return bad


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_decode_checkout: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _lib
    other_dir = Path(sys.argv[1]).resolve()
    _lib.lib(verbose=True)
    other, decode_log = build_other(other_dir, "mla_decode.cu")
    for fn in (other.snapmla_decode, other.snapmla_lse_combine, other.snapmla_amla_combine):
        fn.argtypes = _lib._SIGNATURES[fn.__name__]
        fn.restype = ctypes.c_int
    other_k1, fetch_log = build_other(other_dir, "fetch_dequant.cu")
    other_k1.snapmla_fetch_dequant.argtypes = OTHER_FETCH_ARGS
    other_k1.snapmla_fetch_dequant.restype = ctypes.c_int
    device = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    scale = 1.0 / (128 + CS.D_R) ** 0.5
    total = decode_cases(other, gen, scale, device)
    total["fetch"] = fetch_cases(other_k1, gen, device)
    bad = ptxas_check(_lib.BUILD_LOG, decode_log + fetch_log)
    print(json.dumps(dict(check="this checkout vs the other mla_decode.cu and fetch_dequant.cu",
                          mismatches=total, ptxas_failures=len(bad), device=device)), flush=True)
    return 1 if any(total.values()) or bad else 0


if __name__ == "__main__":
    sys.exit(main())
