"""Wrappers of the SnapMLA decode kernels (CUDA sources in
``repro_torch/csrc/mla_decode.cu``). Each takes ``rescale`` ("fma" or
"amla", the two modes of the reference's ``_block_pipeline``):

  * ``mla_decode_paged_splitkv_cuda`` — kernel A (paged split-KV, q_len = 1)
    with kernel C (FMA) or #4 (AMLA) folded into its epilogue; replaces
    ``repro/kernels/mla_decode/kernel.py::mla_decode_paged_splitkv_pallas``.
    Its FMA fp8 q_len = 1 route at the MLA widths runs the tensor-core design
    ``csrc/mla_decode_sm90.cu`` (``decode_design`` is the rule);
  * ``mla_decode_paged_cuda`` — kernel B (the same kernel in single-pass
    mode); replaces ``mla_decode_paged_pallas``;
  * ``mla_decode_splitkv_cuda`` — #2, kernel A over a contiguous cache, with
    the combine as above; replaces ``mla_decode_splitkv_pallas``;
  * ``mla_decode_cuda`` — #1, kernel B over a contiguous cache; replaces
    ``mla_decode_pallas``;
  * ``lse_combine_cuda`` — kernel C; replaces ``lse_combine_pallas``;
  * ``amla_combine_cuda`` — #4; replaces ``amla_combine_pallas``.

C and #4 also run inside the split kernels' epilogue (below); their
standalone launches serve a caller that keeps the partials.

The contiguous wrappers take the cache's ``sink`` guard shadow: the kernel
substitutes ``sink / max(scale, tiny)`` on rows below ``S_k``.

The two split-KV wrappers also take a rank-4 query block ``[B, q_len, H, .]``
(the speculative verify, the q_len > 1 mode of #6 / #2): ``_flatten_q`` turns
it into ``R = q_len*H`` head-major rows (row = t*H + h) that the kernel's
verify instantiation masks per row at ``seq_len - (q_len - 1) + t``; C or #4
merges R rows, and ``_unflatten_rows`` gives o [B, q_len, H, d_c], lse
[B, q_len, H] back. A rank-4 query with q_len = 1 runs the ordinary kernel
and comes back rank-4. The verify mode takes no sink guard.

Each decode launch computes its heads in tiles of ``head_width(...)`` heads
per CUDA block, one of the two widths the kernel is instantiated for; the
width changes which block computes a head, never a bit of the result.

The query is prepared ``(q_c8, q_r, sigma_q)``, from Fused-Q-Quant (D) or
``ref.prepare_q``, or raw ``(q_lat, q_rope, None)`` in float32 (fp8 and int8
only): the kernel then runs D in its prologue, with D's bits. The split
kernels merge their partials in their epilogue, with C's bits under FMA and
#4's under AMLA, unless the caller asks for the partials; ``launch_plan`` is
that rule. So a decode or verify call is one launch. The folded launches
share per-device scratch (the partials and the ticket counters of the
last-block merge), grown on demand outside any CUDA-graph capture; it
assumes one stream, as the port uses: two folded launches in flight on two
streams would share it.

Two designs compute kernel A. The exact one (``mla_decode.cu``) agrees with
the plain version bit for bit and serves every mode. The sm90 one
(``mla_decode_sm90.cu``: 64 heads a CUDA block, fp8 ``wgmma`` for QK and PV,
float32 sums promoted every 32 products) takes the calls that need none of
the exact design's modes: an fp8 pool, FMA, one query token, d_c 512 and d_r
64, pages of 64 or 128 tokens, C folded, 16-byte aligned tensors. Its sums run
in float32 in another order, so its outputs are the plain version's within
tolerances, not its bits. ``decode_design`` is the rule; ``forced_design``
pins the exact one for a test that holds bits. A call the sm90 design takes
that sets no split count takes its split rule, ``sm90_num_splits``
(``design_num_splits``, which ``ops.snapmla_decode_paged`` asks).
``_lib.LAUNCHES`` counts the two apart: ``paged_splitkv_decode`` and
``paged_splitkv_decode_sm90``.

A wrapper runs its plain PyTorch version (``ref.py``) only when it is handed
CPU tensors; for CUDA tensors it launches the kernel or raises. On the CPU a
raw query runs ``fused_q_quant_ref`` and then the plain version.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.kvcache import patch_sink_rows
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import ref as R
from repro_torch.kernels.quantize.ref import fused_q_quant_ref

FMT_CODES = {"fp8_e4m3": 0, "int8": 1, "none": 2}
STORAGE = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8, "none": torch.bfloat16}
BLOCK_SIZES = (16, 32, 64, 128, 256, 512)   # the KV block sizes the kernel takes
RESCALES = ("fma", "amla")
# head-tile widths instantiated in mla_decode.cu (kWide, kNarrow), widest first
HEAD_WIDTHS = (8, 1)
_TILES = _lib.HeadTiles("head", HEAD_WIDTHS)
# the formats whose raw query the kernels quantize in their prologue (D's)
RAW_FMTS = ("fp8_e4m3", "int8")
# the most splits #4 folds at (mla_decode.cu: kMaxAmlaFoldSplits): its shift
# table must fit one CUDA block's shared memory
AMLA_FOLD_MAX_SPLITS = 4096
# the sm90 design's widths and pages (mla_decode_sm90.cu: kDc, kDr, its
# instantiations) and the heads of one of its CUDA blocks (kHeads)
SM90_D_C, SM90_D_R, SM90_PAGES, SM90_HEADS = 512, 64, (64, 128), 64
# the sm90 design's split rule (sm90_num_splits): the tokens a split aims
# at, and the fewest pages a split holds
SM90_SPLIT_TOKENS = 8192
SM90_MIN_PAGES = 8
_FORCED_DESIGN: list = []


def _check_raw(fmt: str) -> None:
    if fmt not in RAW_FMTS:
        raise ValueError(f"a raw query takes {RAW_FMTS}, not {fmt!r}: prepare it with "
                         "ref.prepare_q")


def launch_plan(*, raw: bool, fmt: str, single_pass: bool, rescale: str,
                return_partials: bool = False, num_splits: int = 1) -> str:
    """The routing rule of every decode wrapper: how a call merges its split
    partials — "folded" (C, or #4 under AMLA, in the split kernel's
    epilogue), "lse_combine" / "amla_combine" (C / #4 launched after the
    kernel, for a caller that keeps the partials, and #4 past
    AMLA_FOLD_MAX_SPLITS splits) or "none" (single pass). A raw query (fp8 /
    int8; a "none" query is prepared by ``prepare_q``) is quantized in the
    kernel's prologue on every route."""
    if rescale not in RESCALES:
        raise ValueError(f"rescale must be one of {RESCALES}, not {rescale!r}")
    if raw:
        _check_raw(fmt)
    if single_pass:
        return "none"
    amla = rescale == "amla"
    if return_partials or (amla and num_splits > AMLA_FOLD_MAX_SPLITS):
        return "amla_combine" if amla else "lse_combine"
    return "folded"


def decode_design(*, fmt: str, rescale: str, q_rank: int, d_c: int, d_r: int, page: int,
                  return_partials: bool = False, aligned: bool = True) -> str:
    """Which design computes a paged split-KV decode call: "sm90" (the
    tensor-core kernel, ``mla_decode_sm90.cu``) for an fp8 pool under FMA
    with one query token (a rank-3 query: a rank-4 verify block, even of one
    token, keeps its rank through the exact design), d_c 512, d_r 64, a page
    of 64 or 128 tokens, C folded (no partials returned) and 16-byte aligned
    tensors; every other call "exact" (``mla_decode.cu``, bit for bit the
    plain version). Contiguous caches (and with them the sink guard) and the
    single pass take the exact design without asking."""
    if _FORCED_DESIGN:
        return _FORCED_DESIGN[-1]
    sm90 = (fmt == "fp8_e4m3" and rescale == "fma" and q_rank == 3 and d_c == SM90_D_C
            and d_r == SM90_D_R and page in SM90_PAGES and not return_partials and aligned)
    return "sm90" if sm90 else "exact"


@contextlib.contextmanager
def forced_design(design: str):
    """Route every split-KV decode call inside the block to ``design``; for
    tests that hold the exact design's bits at shapes the rule sends to sm90
    ("exact" is the only design every call can take)."""
    if design != "exact":
        raise ValueError(f"only the exact design can be forced, not {design!r}")
    _FORCED_DESIGN.append(design)
    try:
        yield
    finally:
        _FORCED_DESIGN.pop()


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _paged_design(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
                  seq_lens, *, fmt, rescale, return_partials=False) -> str:
    """``decode_design`` of a paged split-KV call, read off its tensors."""
    return decode_design(fmt=fmt, rescale=rescale, q_rank=q_c8.dim(), d_c=q_c8.shape[-1],
                         d_r=q_r.shape[-1], page=content_pool.shape[1],
                         return_partials=return_partials,
                         aligned=_aligned(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                          scale_pool, page_table, seq_lens))


def sm90_num_splits(batch: int, heads: int, capacity: int, page: int, sms: int) -> int:
    """The sm90 design's split count (one CUDA block per SM, 64 heads a
    block): splits of about ``SM90_SPLIT_TOKENS`` tokens of the capacity, so
    a block's fixed costs (its query, its pipeline's fill, its partial and
    the merge) stay a few pages' worth and rows of unequal length even out
    over the blocks; at least enough that ``batch * ceil(heads / 64) *
    splits`` blocks cover the SMs; and no split of fewer than
    ``SM90_MIN_PAGES`` pages. A function of the shapes and the SM count only:
    the live lengths are on the device."""
    pages = max(1, capacity // page)
    blocks = batch * -(-heads // SM90_HEADS)
    want = max(-(-capacity // SM90_SPLIT_TOKENS), -(-sms // blocks))
    return max(1, min(want, pages // SM90_MIN_PAGES))


def design_num_splits(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
                      seq_lens, *, fmt, rescale) -> int | None:
    """The split count of a paged call that sets none, by the rule of the
    design it takes: ``sm90_num_splits`` for a card call the sm90 design
    takes (the wrapper's own test), else None: the exact design's plan
    (``ops.resolve_num_splits``, from the profile it was measured for)."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table, seq_lens)
    if _on_cpu(*args) or _paged_design(*args, fmt=fmt, rescale=rescale) != "sm90":
        return None
    B, P = page_table.shape
    page = content_pool.shape[1]
    return sm90_num_splits(B, q_c8.shape[-2], P * page, page,
                           _lib.sm_count(q_c8.device.index or 0))


class _Scratch:
    """Per-device buffers of the folded split launches: the partials (o and
    lse; AMLA's acc, l and g), which each launch writes and reads back
    itself, and the int32 ticket counters of the last-block merge, zeroed
    when allocated and left at zero by every launch. Grown on demand, never inside a CUDA-graph capture (a graph keeps
    the addresses it captured). One stream: the buffers are reused by the
    next launch on it."""

    def __init__(self):
        self._floats: dict = {}
        self._tickets: dict = {}

    @staticmethod
    def _grow(store: dict, dev: torch.device, n: int, make):
        buf = store.get(dev)
        if buf is None or buf.numel() < n:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("repro_torch: the folded decode's scratch must grow "
                                   "outside a CUDA-graph capture; run the call once first")
            buf = store[dev] = make(n)
        return buf

    def partials(self, dev, B, S, H, d_c):
        """Views of o [B*S*H*d_c], lse and g [B*S*H] (g: AMLA only)."""
        n_o, n = B * S * H * d_c, B * S * H
        buf = self._grow(self._floats, dev, n_o + 2 * n,
                         lambda m: torch.empty(m, dtype=torch.float32, device=dev))
        return buf[:n_o], buf[n_o:n_o + n], buf[n_o + n:n_o + 2 * n]

    def tickets(self, dev, n):
        return self._grow(self._tickets, dev, n,
                          lambda m: torch.zeros(m, dtype=torch.int32, device=dev))


_SCRATCH = _Scratch()


def head_width(batch: int, rows: int, splits: int, sms: int) -> int:
    """Heads per CUDA block of one decode launch: the widest instantiated
    width whose grid, ``batch * ceil(rows / width) * splits`` blocks, covers
    the card's ``sms`` SMs (a wider tile re-reads each KV block from L2 fewer
    times), else the narrowest (the most blocks). ``rows`` is the head count,
    ``q_len * heads`` in the verify mode."""
    return _TILES.pick(lambda w: batch * -(-rows // w) * splits, sms)


def forced_head_width(width: int):
    """Launch every decode kernel inside the block at ``width`` heads per
    CUDA block in place of ``head_width``'s pick (to compare the widths)."""
    return _TILES.forcing(width)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _cpu_query(q_c8, q_r, sigma_q, fmt):
    """The prepared query of the plain versions: a raw one (``sigma_q``
    None) through Fused-Q-Quant's plain version."""
    if sigma_q is not None:
        return q_c8, q_r, sigma_q
    _check_raw(fmt)
    return fused_q_quant_ref(torch.cat([q_c8, q_r], dim=-1), q_c8.shape[-1], fmt)


def _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, block):
    H, d_c = q_c8.shape[1:]
    dev = q_c8.device
    if sigma_q is None:   # raw: q_lat, q_rope
        _lib.check(q_c8, "q_lat", torch.float32, (B, H, d_c), dev)
        _lib.check(q_r, "q_rope", torch.float32, (B, H, d_r), dev)
    else:
        _lib.check(q_c8, "q_c8", STORAGE[fmt], (B, H, d_c), dev)
        _lib.check(q_r, "q_r", torch.float32, (B, H, d_r), dev)
        _lib.check(sigma_q, "sigma_q", torch.float32, (B, H), dev)
    _lib.check(seq_lens, "seq_lens", torch.int32, (B,), dev)
    if d_c % 4 or d_r % 2 or block not in BLOCK_SIZES:
        raise ValueError(f"the kernel takes d_c % 4 == 0 (got {d_c}), even d_r "
                         f"(got {d_r}) and a KV block of {BLOCK_SIZES} tokens "
                         f"(got {block})")
    return H, d_c


def _flatten_q(q_c8, q_r, sigma_q):
    """[B, q_len, H, .] -> head-major rows [B, q_len*H, .], with (q_len, H);
    a rank-3 query passes through with q_len None (kernel.py:485-497); a raw
    query's ``sigma_q`` stays None."""
    if q_c8.dim() == 3:
        return q_c8, q_r, sigma_q, None, q_c8.shape[1]
    B, q_len, H = q_c8.shape[:3]
    return (q_c8.reshape(B, q_len * H, -1), q_r.reshape(B, q_len * H, -1),
            None if sigma_q is None else sigma_q.reshape(B, q_len * H), q_len, H)


def _unflatten_rows(q_len, H, o, lse, partials):
    """Undo ``_flatten_q`` on the outputs and partials (kernel.py:500-513)."""
    if q_len is None:
        return o, lse, partials
    B = o.shape[0]
    o, lse = o.reshape(B, q_len, H, -1), lse.reshape(B, q_len, H)
    if partials is not None:
        o_p, lse_p, sp_p = partials
        S = o_p.shape[1]
        partials = (o_p.reshape(B, S, q_len, H, -1), lse_p.reshape(B, S, q_len, H),
                    sp_p.reshape(B, S, q_len, H))
    return o, lse, partials


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_decode(kernel: str, fmt: str, single_pass: bool, rescale: str, q_c8, q_r,
                   sigma_q, content, rope, scale, page_table, seq_lens, sink, *, B, H,
                   d_c, d_r, block, P, num_splits, softmax_scale, q_len=1, fold=False):
    """Launch one decode kernel on a prepared or a raw (``sigma_q`` None)
    query. Returns the partials it allocated, o [B, S, H, d_c], lse [B, S, H]
    and (split mode) sigma_p or, under AMLA, g [B, S, H]; with ``fold`` (C or
    #4 in the split epilogue) the merged (o [B, H, d_c], lse [B, H], None)."""
    if not 1 <= num_splits <= P:
        raise ValueError(f"num_splits={num_splits} outside [1, {P}]")
    dev = q_c8.device
    amla = rescale == "amla"
    if fold:
        if single_pass:
            raise ValueError("C and #4 fold into the split kernels only")
        o_p, lse_p, g_p = _SCRATCH.partials(dev, B, num_splits, H, d_c)
        tickets = _SCRATCH.tickets(dev, B * H)   # B x head tiles at any width
        sp_p = g_p if amla else None
        o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
        lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    else:
        o_p = torch.empty((B, num_splits, H, d_c), dtype=torch.float32, device=dev)
        lse_p = torch.empty((B, num_splits, H), dtype=torch.float32, device=dev)
        sp_p = None if single_pass else torch.empty_like(lse_p)
        o = lse = tickets = None
    prepared, raw = ((q_c8, q_r, sigma_q), (None, None)) if sigma_q is not None else \
        ((None, None, None), (q_c8, q_r))
    if q_len > 1:
        kernel += "_verify"
    width = _TILES.forced or head_width(B, H, num_splits, _lib.sm_count(dev.index or 0))
    _lib.launch(
        kernel + ("_amla" if amla else ""), "snapmla_decode", FMT_CODES[fmt],
        int(single_pass), int(amla), *map(_ptr, prepared), *map(_ptr, raw),
        content.data_ptr(), rope.data_ptr(), scale.data_ptr(), _ptr(page_table),
        seq_lens.data_ptr(), _ptr(sink), 0 if sink is None else sink.shape[1],
        o_p.data_ptr(), lse_p.data_ptr(), _ptr(sp_p), _ptr(o), _ptr(lse), _ptr(tickets),
        B, H, d_c, d_r, block, P, num_splits, -(-P // num_splits), float(softmax_scale),
        q_len, width)
    return (o, lse, None) if fold else (o_p, lse_p, sp_p)


def _check_paged(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
                 seq_lens, fmt):
    """Check a paged call's tensors: (B, P, H, d_c, d_r, page)."""
    B, P = page_table.shape
    n_pages, page, _ = content_pool.shape
    d_r = q_r.shape[-1]
    H, d_c = _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, page)
    dev = q_c8.device
    _lib.check(content_pool, "content_pool", STORAGE[fmt], (n_pages, page, d_c), dev)
    _lib.check(rope_pool, "rope_pool", torch.bfloat16, (n_pages, page, d_r), dev)
    _lib.check(scale_pool, "scale_pool", torch.float32, (n_pages, page), dev)
    _lib.check(page_table, "page_table", torch.int32, (B, P), dev)
    return B, P, H, d_c, d_r, page


def _paged_launch(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
                  seq_lens, *, softmax_scale, num_splits, fmt, single_pass, rescale,
                  q_len=1, fold=False):
    """Check a paged call's tensors and launch A or B on the pool."""
    launch_plan(raw=sigma_q is None, fmt=fmt, single_pass=single_pass, rescale=rescale)
    B, P, H, d_c, d_r, page = _check_paged(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                           scale_pool, page_table, seq_lens, fmt)
    return _launch_decode(
        "paged_single_pass_decode" if single_pass else "paged_splitkv_decode", fmt,
        single_pass, rescale, q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
        page_table, seq_lens, None, B=B, H=H, d_c=d_c, d_r=d_r, block=page, P=P,
        num_splits=num_splits, softmax_scale=softmax_scale, q_len=q_len, fold=fold)


def _paged_sm90(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
                seq_lens, *, softmax_scale, num_splits):
    """Launch the sm90 design of A with C folded (``decode_design`` chose it):
    (o [B, H, d_c], lse [B, H])."""
    launch_plan(raw=sigma_q is None, fmt="fp8_e4m3", single_pass=False, rescale="fma")
    B, P, H, d_c, _, page = _check_paged(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                         scale_pool, page_table, seq_lens, "fp8_e4m3")
    if not 1 <= num_splits <= P:
        raise ValueError(f"num_splits={num_splits} outside [1, {P}]")
    dev = q_c8.device
    o_p, lse_p, _ = _SCRATCH.partials(dev, B, num_splits, H, d_c)
    tickets = _SCRATCH.tickets(dev, B * H)   # B x head groups
    o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    prepared, raw = ((q_c8, q_r, sigma_q), (None, None)) if sigma_q is not None else \
        ((None, None, None), (q_c8, q_r))
    _lib.launch(
        "paged_splitkv_decode_sm90", "snapmla_decode_sm90", *map(_ptr, prepared),
        *map(_ptr, raw), content_pool.data_ptr(), rope_pool.data_ptr(), scale_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), o_p.data_ptr(), lse_p.data_ptr(),
        o.data_ptr(), lse.data_ptr(), tickets.data_ptr(), B, H, content_pool.shape[0], page, P,
        num_splits, -(-P // num_splits), float(softmax_scale))
    return o, lse


def _contiguous_launch(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                       softmax_scale, block_n, num_splits, fmt, single_pass, rescale,
                       sink=None, q_len=1, fold=False):
    """Check a contiguous call's tensors and launch #2 or #1 on the cache."""
    launch_plan(raw=sigma_q is None, fmt=fmt, single_pass=single_pass, rescale=rescale)
    B, N, _ = content.shape
    d_r = q_r.shape[-1]
    H, d_c = _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, block_n)
    if N % block_n:
        raise ValueError(f"cache capacity {N} is not a multiple of block_n={block_n}")
    dev = q_c8.device
    _lib.check(content, "content", STORAGE[fmt], (B, N, d_c), dev)
    _lib.check(rope, "rope", torch.bfloat16, (B, N, d_r), dev)
    _lib.check(scale, "scale", torch.float32, (B, N), dev)
    if sink is not None:
        if q_len > 1:
            raise NotImplementedError("the verify mode (q_len > 1) takes no sink guard")
        _lib.check(sink, "sink", torch.float32, (B, sink.shape[1], d_c), dev)
    return _launch_decode(
        "single_pass_decode" if single_pass else "splitkv_decode", fmt, single_pass,
        rescale, q_c8, q_r, sigma_q, content, rope, scale, None, seq_lens, sink, B=B, H=H,
        d_c=d_c, d_r=d_r, block=block_n, P=N // block_n, num_splits=num_splits,
        softmax_scale=softmax_scale, q_len=q_len, fold=fold)


def paged_decode_partials_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                               scale_pool, page_table, seq_lens, *,
                               softmax_scale: float, num_splits: int, fmt: str,
                               single_pass: bool, rescale: str = "fma", q_len: int = 1):
    """Launch kernel A (``single_pass=False``) or B: per-split partials
    (o [B, S, H, d_c], lse [B, S, H], sigma_p [B, S, H] — sigma_p only for A;
    under AMLA, A's partials are the raw (acc, l, g)). ``q_len > 1``: A's
    verify mode over flattened rows (H is then q_len * heads; CUDA only).
    The query may be raw (``sigma_q`` None): D then runs in the prologue."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        args = _cpu_query(q_c8, q_r, sigma_q, fmt) + args[3:]
        if single_pass:
            o, lse = R.snapmla_decode_paged_ref(*args, softmax_scale=softmax_scale,
                                                fmt=fmt, rescale=rescale)
            return o[:, None], lse[:, None], None
        return R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
            return_partials=True, rescale=rescale)[2]
    return _paged_launch(*args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
                         single_pass=single_pass, rescale=rescale, q_len=q_len)


def decode_partials_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                         softmax_scale: float, block_n: int, num_splits: int, fmt: str,
                         single_pass: bool, rescale: str = "fma",
                         sink: torch.Tensor | None = None, q_len: int = 1):
    """Launch #2 (``single_pass=False``) or #1 over a contiguous cache
    (content [B, N, d_c], rope [B, N, d_r] bf16, scale [B, N]) in blocks of
    ``block_n`` tokens: per-split partials as ``paged_decode_partials_cuda``."""
    args = (q_c8, q_r, sigma_q, content, rope, scale, seq_lens)
    if _on_cpu(*args, sink):
        ref_args = _cpu_query(q_c8, q_r, sigma_q, fmt) + (
            patch_sink_rows(content, scale, sink), rope.float(), scale, seq_lens)
        if single_pass:
            o, lse = R.snapmla_decode_pipeline_ref(
                *ref_args, softmax_scale=softmax_scale, block_n=block_n, fmt=fmt,
                rescale=rescale)
            return o[:, None], lse[:, None], None
        return R.snapmla_decode_splitkv_ref(
            *ref_args, softmax_scale=softmax_scale, num_splits=num_splits,
            block_n=block_n, fmt=fmt, return_partials=True, rescale=rescale)[2]
    return _contiguous_launch(*args, softmax_scale=softmax_scale, block_n=block_n,
                              num_splits=num_splits, fmt=fmt, single_pass=single_pass,
                              rescale=rescale, sink=sink, q_len=q_len)


def lse_combine_cuda(o_partial: torch.Tensor, lse_partial: torch.Tensor):
    """Kernel C: o_partial [B, S, H, d_c] f32, lse_partial [B, S, H] f32 ->
    (o [B, H, d_c], lse [B, H])."""
    if _on_cpu(o_partial, lse_partial):
        return R.lse_combine_ref(o_partial, lse_partial)
    B, S, H, d_c = o_partial.shape
    dev = o_partial.device
    _lib.check(o_partial, "o_partial", torch.float32, (B, S, H, d_c), dev)
    _lib.check(lse_partial, "lse_partial", torch.float32, (B, S, H), dev)
    o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    _lib.launch("lse_combine", "snapmla_lse_combine", o_partial.data_ptr(),
                lse_partial.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H, d_c)
    return o, lse


def amla_combine_cuda(acc_partial: torch.Tensor, l_partial: torch.Tensor,
                      g_partial: torch.Tensor):
    """#4: raw AMLA partials acc [B, S, H, d_c], l [B, S, H], g [B, S, H]
    (all f32) -> (o [B, H, d_c], lse [B, H])."""
    if _on_cpu(acc_partial, l_partial, g_partial):
        return R.amla_combine_ref(acc_partial, l_partial, g_partial)
    B, S, H, d_c = acc_partial.shape
    dev = acc_partial.device
    _lib.check(acc_partial, "acc_partial", torch.float32, (B, S, H, d_c), dev)
    _lib.check(l_partial, "l_partial", torch.float32, (B, S, H), dev)
    _lib.check(g_partial, "g_partial", torch.float32, (B, S, H), dev)
    o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    _lib.launch("amla_combine", "snapmla_amla_combine", acc_partial.data_ptr(),
                l_partial.data_ptr(), g_partial.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, S, H, d_c)
    return o, lse


def combine_cuda(partials, rescale: str = "fma"):
    """Merge split partials with kernel C (FMA) or #4 (AMLA)."""
    o_p, lse_p, sp_p = partials
    if rescale == "amla":
        return amla_combine_cuda(o_p, lse_p, sp_p)
    return lse_combine_cuda(o_p, lse_p)


def _split_decode(launch, q_c8, q_r, sigma_q, cache_args, *, fmt, rescale, return_partials,
                  **kw):
    """A split-KV call on the card: flatten a verify block, launch by
    ``launch_plan`` (C or #4 folded, or the kernel then C / #4), unflatten."""
    route = launch_plan(raw=sigma_q is None, fmt=fmt, single_pass=False, rescale=rescale,
                        return_partials=return_partials, num_splits=kw["num_splits"])
    qc, qr, sq, q_len, H = _flatten_q(q_c8, q_r, sigma_q)
    kw.update(fmt=fmt, single_pass=False, rescale=rescale, q_len=q_len or 1)
    if route == "folded":
        o, lse, parts = launch(qc, qr, sq, *cache_args, fold=True, **kw)
    else:
        parts = launch(qc, qr, sq, *cache_args, **kw)
        o, lse = combine_cuda(parts, rescale)
    o, lse, parts = _unflatten_rows(q_len, H, o, lse, parts)
    return (o, lse, parts) if return_partials else (o, lse)


def mla_decode_paged_splitkv_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                  scale_pool, page_table, seq_lens, *,
                                  softmax_scale: float, num_splits: int,
                                  fmt: str = "fp8_e4m3",
                                  return_partials: bool = False, rescale: str = "fma"):
    """Paged split-KV SnapMLA decode (kernel A with C or #4 folded, or A
    then C or #4, by ``launch_plan``). Returns (o [B, (q_len,) H, d_c] f32, lse
    [B, (q_len,) H]) — plus the partials when ``return_partials``."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_splitkv_ref(
            *_cpu_query(q_c8, q_r, sigma_q, fmt), *args[3:], softmax_scale=softmax_scale,
            num_splits=num_splits, fmt=fmt, return_partials=return_partials,
            rescale=rescale)
    if _paged_design(*args, fmt=fmt, rescale=rescale,
                     return_partials=return_partials) == "sm90":
        return _paged_sm90(*args, softmax_scale=softmax_scale, num_splits=num_splits)
    return _split_decode(_paged_launch, q_c8, q_r, sigma_q, args[3:], fmt=fmt,
                         rescale=rescale, return_partials=return_partials,
                         softmax_scale=softmax_scale, num_splits=num_splits)


def mla_decode_paged_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
                          page_table, seq_lens, *, softmax_scale: float,
                          fmt: str = "fp8_e4m3", rescale: str = "fma"):
    """Paged single-pass SnapMLA decode (kernel B, no early exit). Returns
    (o [B, H, d_c] f32, lse [B, H])."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_ref(*_cpu_query(q_c8, q_r, sigma_q, fmt), *args[3:],
                                          softmax_scale=softmax_scale, fmt=fmt,
                                          rescale=rescale)
    o_p, lse_p, _ = paged_decode_partials_cuda(
        *args, softmax_scale=softmax_scale, num_splits=1, fmt=fmt, single_pass=True,
        rescale=rescale)
    return o_p[:, 0], lse_p[:, 0]


def mla_decode_splitkv_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                            softmax_scale: float, num_splits: int, block_n: int = 128,
                            fmt: str = "fp8_e4m3", return_partials: bool = False,
                            rescale: str = "fma", sink: torch.Tensor | None = None):
    """Contiguous split-KV SnapMLA decode (#2 with C or #4 folded, or #2
    then C or #4, by ``launch_plan``). Returns (o [B, (q_len,) H, d_c] f32, lse
    [B, (q_len,) H]) — plus the partials when ``return_partials``."""
    if _on_cpu(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, sink):
        return R.snapmla_decode_splitkv_ref(
            *_cpu_query(q_c8, q_r, sigma_q, fmt), patch_sink_rows(content, scale, sink),
            rope.float(), scale, seq_lens, softmax_scale=softmax_scale,
            num_splits=num_splits, block_n=block_n, fmt=fmt,
            return_partials=return_partials, rescale=rescale)
    return _split_decode(_contiguous_launch, q_c8, q_r, sigma_q, (content, rope, scale,
                                                                  seq_lens),
                         fmt=fmt, rescale=rescale, return_partials=return_partials,
                         softmax_scale=softmax_scale, block_n=block_n,
                         num_splits=num_splits, sink=sink)


def mla_decode_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                    softmax_scale: float, block_n: int = 128, fmt: str = "fp8_e4m3",
                    rescale: str = "fma", sink: torch.Tensor | None = None):
    """Contiguous single-pass SnapMLA decode (#1, no early exit). Returns
    (o [B, H, d_c] f32, lse [B, H])."""
    o_p, lse_p, _ = decode_partials_cuda(
        q_c8, q_r, sigma_q, content, rope, scale, seq_lens, softmax_scale=softmax_scale,
        block_n=block_n, num_splits=1, fmt=fmt, single_pass=True, rescale=rescale,
        sink=sink)
    return o_p[:, 0], lse_p[:, 0]
