#!/usr/bin/env python3
"""Hold this checkout's MLA decode launches, its fused fetch-dequant (K1) and
its token-preparation kernels (D, #9) against another checkout's
``mla_decode.cu``, ``fetch_dequant.cu``, ``q_quant.cu`` and ``k_append.cu``
on one NVIDIA GPU, bit for bit, at chip_smoke.py's cases, both rescale modes.

    python3 scripts/compare_decode_checkout.py OTHER_CHECKOUT [--token-prep]

``--token-prep`` holds D and #9 only.

OTHER_CHECKOUT is a checkout (``git archive`` of a commit) with the four
sources (under ``src/repro_torch/csrc/``). Each entry point of the other's
is called with the argument list of its own prototype, read from its source
(``OtherEntry``): parameters by name, so an entry point that lacks one of
this checkout's (K1's tokens per warp, D's and #9's ``full``) is called
without it; ``snapmla_decode`` must take the raw query and the folded outputs
(left nullptr: the script hands it the prepared query and leaves the merge
to its standalone C and #4). The script builds each of the sources, with its
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
    int8 and bf16 caches;
  * ``d`` / ``k9``: D at chip_smoke's ``D_CASES`` and #9 at ``K9_CASES``,
    each also on views not 16-byte aligned, fp8 and int8, against the
    other's on the same inputs.

Each count is the number of 32-bit words that differ (16-bit for K1's bf16
output). Then device ms (chip_smoke's ``kernel_ms``: CUDA-graph replays,
L2-warm), the two checkouts timed in turns (other, this, this, other): on
the paged pool at the split counts of ``TIMED``, the other kernel and this
one on the prepared query (``other_kernel_ms``, ``kernel_ms``), and the
other checkout's launches D, kernel, C or #4 (D, kernel in single pass)
against this checkout's folded call (``other_chain_ms``, ``folded_ms``); the
standalone #4 on the same partials; K1 bounded and #10 at the engine's shape
and at ~32k; D (fp8) at ``serve_shape``, ``serve_shape_h128`` and
``deepseek_b64`` (L2 cold: chip_smoke's ``rotating`` inputs) and #9 at
``serve_shape``, ``long_32k`` and ``b64``, on inputs with no all-zero row,
each with ``no_slower`` (this checkout's ms within the other's), and at
``serve_shape`` also on the EPS-floor row's inputs (``ms_eps_row``).
Last, each MLA decode instantiation's registers and spill bytes in both
builds, and D's and #9's: an AMLA split instantiation that spills more
than the other's, a width-1 instantiation past 64 registers where the
other's was within (two blocks of 512 threads per SM), or a K1, D or #9
spill fails (``--token-prep``: D and #9 only). Prints one
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

# #9's cases: (tag, batch, capacity, d_c, d_r, timed), with chip_smoke's K9_CASES
K9_COMPARE = [("serve_shape", 4, 640, 512, 64, True), ("long_32k", 4, 32768, 512, 64, True),
              ("b64", 64, 640, 512, 64, True)]
D_TIMED = ("serve_shape", "serve_shape_h128", "deepseek_b64")
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


class OtherEntry:
    """The other checkout's C entry point ``name``: its parameter names and
    ctypes argtypes read from its prototype in ``source``, so that a checkout
    of any PR is called with its own argument list; a call gives each
    parameter by name (a value the other does not take is left out)."""

    def __init__(self, handle: ctypes.CDLL, source: str, name: str):
        proto = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
        if proto is None:
            raise RuntimeError(f"the other checkout has no entry point {name}")
        self.name, self.params, types = name, [], []
        for param in proto[1].split(","):
            kind, _, pname = param.strip().rpartition(" ")
            self.params.append(pname.lstrip("*"))
            types.append(ctypes.c_void_p if "*" in param else
                         ctypes.c_float if kind == "float" else ctypes.c_int)
        self.fn = getattr(handle, name)
        self.fn.argtypes, self.fn.restype = types, ctypes.c_int

    def __call__(self, **values) -> None:
        missing = [p for p in self.params if p not in values]
        if missing:
            raise TypeError(f"the other checkout's {self.name} takes {missing}, not given here")
        rc = self.fn(*(values[p] for p in self.params))
        if rc:
            raise RuntimeError(f"the other checkout's {self.name} failed: {rc}")


class OtherBuild:
    """The other checkout's ``source`` built into its own library (with its
    own common.cuh), each of ``entries`` an ``OtherEntry`` attribute;
    ``log`` is ptxas's report."""

    def __init__(self, other: Path, source: str, entries: tuple[str, ...]):
        from repro_torch.kernels import _lib
        csrc = other / "src" / "repro_torch" / "csrc"
        src = b"".join((csrc / name).read_bytes() for name in (source, "common.cuh",
                                                                "mla_merge.cuh")
                       if (csrc / name).exists())
        digest = hashlib.sha256(src).hexdigest()[:16]
        out = _lib.BUILD_DIR / f"other_{Path(source).stem}_{digest}.so"
        log_path = out.with_suffix(".log")
        if not (out.exists() and log_path.exists()):
            _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            done = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                                   "-I", str(csrc), str(csrc / source), "-o", str(out)],
                                  capture_output=True, text=True, check=True)
            log_path.write_text(done.stdout + done.stderr)
        self.log = log_path.read_text()
        handle, text = ctypes.CDLL(str(out)), (csrc / source).read_text()
        for name in entries:
            setattr(self, name, OtherEntry(handle, text, name))


def mismatches(a, b) -> int:
    import torch
    view = torch.int16 if a.element_size() == 2 else torch.int32

    def words(t):   # a copy: a view may start off a word boundary
        t = t.clone()
        return (t.view(torch.uint8) if t.element_size() == 1 else t).view(view)
    a, b = words(a), words(b)
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
    other.snapmla_decode(
        fmt=K.FMT_CODES[fmt], single_pass=int(single_pass), amla=int(amla), q_c8=q[0].data_ptr(),
        q_r=q[1].data_ptr(), sigma_q=q[2].data_ptr(), q_lat=None, q_rope=None,
        content=content.data_ptr(), rope=rope.data_ptr(), scale=scale_t.data_ptr(),
        page_table=None if page_table is None else page_table.data_ptr(),
        seq_lens=seq_lens.data_ptr(), sink=None if sink is None else sink.data_ptr(),
        S_k=0 if sink is None else sink.shape[1], o_part=o_p.data_ptr(), lse_part=lse_p.data_ptr(),
        sp_part=None if sp_p is None else sp_p.data_ptr(), o=None, lse=None, tickets=None, B=B,
        H=R, d_c=D_C, d_r=D_R, block=PAGE, P=P, num_splits=S, blocks_per_split=-(-P // S),
        softmax_scale=float(scale), q_len=q_len, width=K.head_width(B, R, S, _lib.sm_count(0)),
        stream=_stream())
    return o_p, lse_p, sp_p


def other_combine(other, parts, amla):
    """The other checkout's standalone C (FMA) or #4 (AMLA) on raw partials."""
    import torch
    B, S, R, d_c = parts[0].shape
    o = torch.empty((B, R, d_c), dtype=torch.float32, device="cuda")
    lse = torch.empty((B, R), dtype=torch.float32, device="cuda")
    shape = dict(o=o.data_ptr(), lse=lse.data_ptr(), B=B, S=S, H=R, d_c=d_c, stream=_stream())
    if amla:
        other.snapmla_amla_combine(acc_part=parts[0].data_ptr(), l_part=parts[1].data_ptr(),
                                   g_part=parts[2].data_ptr(), **shape)
    else:
        other.snapmla_lse_combine(o_part=parts[0].data_ptr(), lse_part=parts[1].data_ptr(),
                                  **shape)
    return o, lse


def other_fetch(other, content, rope, scale, page_table, chunk_start, *, B, P, page):
    """The other checkout's K1 (at this checkout's tokens per warp where its
    entry point takes one)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quantize import fetch_dequant as FD
    d_c, d_r = content.shape[-1], rope.shape[-1]
    out = torch.empty((B, P * page, d_c + d_r), dtype=torch.bfloat16, device="cuda")
    other.snapmla_fetch_dequant(
        fmt=FD.FMT_CODES[content.dtype], content=content.data_ptr(), rope=rope.data_ptr(),
        scale=scale.data_ptr(), page_table=None if page_table is None else page_table.data_ptr(),
        chunk_start=None if chunk_start is None else chunk_start.data_ptr(), out=out.data_ptr(),
        B=B, P=P, page=page, d_c=d_c, d_r=d_r,
        tpw=FD.fetch_geometry(B, P, page, _lib.sm_count(0))[0], stream=_stream())
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


def other_q_quant(other, q, d_c, fmt):
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.quantize import kernel as QK
    B, H, d = q.shape
    out = (torch.empty((B, H, d_c), dtype=quant.qdtype_for(fmt), device="cuda"),
           torch.empty((B, H, d - d_c), dtype=torch.float32, device="cuda"),
           torch.empty((B, H), dtype=torch.float32, device="cuda"))
    full = QK.token_prep_plan("q_quant", B * H, d_c, d - d_c, QK._aligned(q, *out))[0]
    other.snapmla_fused_q_quant(fmt=QK.FMT_CODES[fmt], q=q.data_ptr(), q_c8=out[0].data_ptr(),
                                q_r=out[1].data_ptr(), sigma_q=out[2].data_ptr(), B=B, H=H,
                                d_c=d_c, d_r=d - d_c, full=int(full), stream=_stream())
    return out


def other_k_append(other, content, rope, scale, c, r, lens, fmt):
    from repro_torch.kernels.quantize import kernel as QK
    B, N, d_c = content.shape
    full = QK.token_prep_plan("k_append", B, d_c, rope.shape[-1],
                              QK._aligned(c, r, content, rope, scale, lens))[0]
    other.snapmla_fused_k_append(fmt=QK.FMT_CODES[fmt], c_kv=c.data_ptr(), k_r=r.data_ptr(),
                                 content=content.data_ptr(), rope=rope.data_ptr(),
                                 scale=scale.data_ptr(), seq_lens=lens.data_ptr(), B=B, N=N,
                                 d_c=d_c, d_r=rope.shape[-1], full=int(full), stream=_stream())
    return content, rope, scale


def token_prep_cases(other_d, other_k9, gen, device) -> dict:
    """D and #9 against the other's: the counts; ms in turns."""
    import torch
    import chip_smoke as CS
    from repro_torch.kernels.quantize import kernel as QK
    total = {"d": 0, "k9": 0}
    for fmt in ("fp8_e4m3", "int8"):
        for tag, B, heads, d_c, d_r in CS.D_CASES:
            q = torch.randn(B, heads, d_c + d_r, generator=gen, device="cuda") * 3
            q[0, 0, :d_c] = 0.0
            theirs = other_q_quant(other_d, q, d_c, fmt)
            count = sum(mismatches(a, b) for copy in (torch.clone, CS._unaligned)
                        for a, b in zip(QK.fused_q_quant_cuda(copy(q), d_c, fmt=fmt), theirs))
            total["d"] += count
            line = dict(case=tag, kernel="D fused_q_quant", fmt=fmt, batch=B, heads=heads,
                        d_c=d_c, d_r=d_r, mismatches=count)
            if fmt == "fp8_e4m3" and tag in D_TIMED:
                # timed on rows with no all-zero content (q above has one)
                qt = torch.randn(B, heads, d_c + d_r, generator=gen, device="cuda") * 3
                keep: list = []
                if tag == "deepseek_b64":   # L2 cold, as chip_smoke times it
                    inputs = [qt] + [torch.randn_like(qt) for _ in range(2)]
                    this = {"ms": CS.rotating(inputs, lambda x: QK.fused_q_quant_cuda(x, d_c),
                                              keep)}
                    theirs_fn = {"other_ms": CS.rotating(
                        inputs, lambda x: other_q_quant(other_d, x, d_c, fmt), keep)}
                else:
                    this = {"ms": lambda: QK.fused_q_quant_cuda(qt, d_c)}
                    theirs_fn = {"other_ms": lambda: other_q_quant(other_d, qt, d_c, fmt)}
                if tag == "serve_shape":    # and on the EPS-floor row's input
                    this["ms_eps_row"] = lambda: QK.fused_q_quant_cuda(q, d_c)
                    theirs_fn["other_ms_eps_row"] = lambda: other_q_quant(other_d, q, d_c, fmt)
                line.update(time_pair(theirs_fn, this), device=device)
                line["no_slower"] = line["ms"] <= line["other_ms"]
                keep.clear()
            print(json.dumps(line), flush=True)
        for tag, B, N, d_c, d_r, timed in K9_COMPARE + [c + (False,) for c in CS.K9_CASES]:
            qdt = torch.float8_e4m3fn if fmt == "fp8_e4m3" else torch.int8
            cache = (torch.zeros(B, N, d_c, dtype=torch.uint8, device="cuda").view(qdt),
                     torch.zeros(B, N, d_r, dtype=torch.bfloat16, device="cuda"),
                     torch.zeros(B, N, device="cuda"))
            c = torch.randn(B, d_c, generator=gen, device="cuda") * 3
            r = torch.randn(B, d_r, generator=gen, device="cuda") * 10
            c[0] = 0.0
            lens = torch.randint(0, N, (B,), generator=gen, device="cuda", dtype=torch.int32)
            lens[-1] = N + 2
            theirs = other_k_append(other_k9, *(t.clone() for t in cache), c, r, lens, fmt)
            count = 0
            for copy in (torch.clone, CS._unaligned):
                mine = [copy(t) for t in cache]
                QK.fused_k_append_cuda(*mine, copy(c), copy(r), lens, fmt=fmt)
                count += sum(mismatches(a, b) for a, b in zip(mine, theirs))
            total["k9"] += count
            line = dict(case=tag, kernel="#9 fused_k_append", fmt=fmt, batch=B, capacity=N,
                        d_c=d_c, d_r=d_r, mismatches=count)
            if fmt == "fp8_e4m3" and timed:
                # timed on entries with no all-zero row (c above has one)
                ct = torch.randn(B, d_c, generator=gen, device="cuda") * 3
                rt = torch.randn(B, d_r, generator=gen, device="cuda") * 10
                theirs_fn = {"other_ms": lambda: other_k_append(other_k9, *cache, ct, rt, lens,
                                                                fmt)}
                this = {"ms": lambda: QK.fused_k_append_cuda(*cache, ct, rt, lens)}
                if tag == "serve_shape":    # and on the EPS-floor row's entries
                    theirs_fn["other_ms_eps_row"] = lambda: other_k_append(other_k9, *cache, c, r,
                                                                           lens, fmt)
                    this["ms_eps_row"] = lambda: QK.fused_k_append_cuda(*cache, c, r, lens)
                line.update(time_pair(theirs_fn, this), device=device)
                line["no_slower"] = line["ms"] <= line["other_ms"]
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
    args = sys.argv[1:]
    token_only = "--token-prep" in args
    args = [a for a in args if a != "--token-prep"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_decode_checkout: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mla_decode import kernel as K
    other_dir = Path(args[0]).resolve()
    _lib.lib(verbose=True)
    device = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    total, bad, sources = {}, [], ["q_quant.cu", "k_append.cu"]
    if not token_only:
        other = OtherBuild(other_dir, "mla_decode.cu",
                           ("snapmla_decode", "snapmla_lse_combine", "snapmla_amla_combine"))
        other_k1 = OtherBuild(other_dir, "fetch_dequant.cu", ("snapmla_fetch_dequant",))
        scale = 1.0 / (128 + CS.D_R) ** 0.5
        with K.forced_design("exact"):   # this checkout's A as the other's: its exact design
            total = decode_cases(other, gen, scale, device)
        total["fetch"] = fetch_cases(other_k1, gen, device)
        bad = ptxas_check(_lib.BUILD_LOG, other.log + other_k1.log)
        sources = ["mla_decode.cu", "fetch_dequant.cu"] + sources
    other_d = OtherBuild(other_dir, "q_quant.cu", ("snapmla_fused_q_quant",))
    other_k9 = OtherBuild(other_dir, "k_append.cu", ("snapmla_fused_k_append",))
    total.update(token_prep_cases(other_d, other_k9, gen, device))
    try:
        this_rows = CS.token_prep_ptxas()
    except AssertionError as exc:
        bad.append(str(exc))
        this_rows = None
    other_rows = {name[:48]: row
                  for name, row in CS.ptxas_entries(other_d.log + other_k9.log).items()}
    print(json.dumps(dict(check="D / #9 ptxas", this=this_rows, other=other_rows)), flush=True)
    print(json.dumps(dict(check=f"this checkout vs the other {', '.join(sources)}",
                          mismatches=total, ptxas_failures=len(bad), device=device)), flush=True)
    return 1 if any(total.values()) or bad else 0


if __name__ == "__main__":
    sys.exit(main())
