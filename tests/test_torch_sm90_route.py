"""The sm90 design of the paged split-KV decode (``csrc/mla_decode_sm90.cu``)
on the CPU: the rule that sends a call to it or to the exact design
(``kernels/mla_decode/kernel.py::decode_design``), the wrapper's launch by
that rule (a launch is captured in place of the call), its split rule
(``kernel.sm90_num_splits``, which ``ops.snapmla_decode_paged`` takes for a
card call that sets no split count only where the wrapper's own test,
``kernel.design_num_splits``, sends the call to the design), and its kernel's declared name
against the benchmark's kernel-name patterns. The kernel itself runs on the
card: tests/test_torch_sm90_cuda.py."""
import itertools
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.kernels.mla_decode import ops

ROOT = Path(__file__).resolve().parents[1]
SM90_SRC = ROOT / "src" / "repro_torch" / "csrc" / "mla_decode_sm90.cu"
H100_SMS = 132

FMTS = ("fp8_e4m3", "int8", "none")
RESCALES = ("fma", "amla")
RANKS = (3, 4)
WIDTHS = ((512, 64), (256, 64), (512, 32), (64, 16))
PAGES = (16, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("fmt,rescale,q_rank", list(itertools.product(FMTS, RESCALES, RANKS)))
def test_design_rule_over_every_combination(fmt, rescale, q_rank):
    """sm90 exactly for an fp8 FMA rank-3 call at d_c 512, d_r 64, a page of
    64 or 128, C folded, aligned; returned partials or an unaligned tensor
    keep the exact design whatever else holds (contiguous caches, the sink
    guard's only home, never ask: the wrapper tests below)."""
    for (d_c, d_r), page in itertools.product(WIDTHS, PAGES):
        kw = dict(fmt=fmt, rescale=rescale, q_rank=q_rank, d_c=d_c, d_r=d_r, page=page)
        want = ("sm90" if (fmt, rescale, q_rank, d_c, d_r) == ("fp8_e4m3", "fma", 3, 512, 64)
                and page in (64, 128) else "exact")
        assert K.decode_design(**kw) == want, kw
        assert K.decode_design(**kw, return_partials=True) == "exact"
        assert K.decode_design(**kw, aligned=False) == "exact"


def test_forced_design_pins_the_exact_design_and_refuses_sm90():
    kw = dict(fmt="fp8_e4m3", rescale="fma", q_rank=3, d_c=512, d_r=64, page=128)
    assert K.decode_design(**kw) == "sm90"
    with K.forced_design("exact"):
        assert K.decode_design(**kw) == "exact"
        with K.forced_design("exact"):
            assert K.decode_design(**kw) == "exact"
        assert K.decode_design(**kw) == "exact"
    assert K.decode_design(**kw) == "sm90"
    with pytest.raises(ValueError, match="exact"):
        with K.forced_design("sm90"):
            pass


class Launched(Exception):
    pass


@pytest.fixture
def captured(monkeypatch):
    """Capture the wrapper's launch (kernel name, entry point, arguments) in
    place of a launch, as if the tensors were on the card."""
    seen = {}

    def launch(kernel, fn_name, *args):
        seen.update(kernel=kernel, fn=fn_name, args=args)
        raise Launched

    monkeypatch.setattr(K, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(_lib, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(_lib, "launch", launch)
    return seen


def _paged(fmt, H, d_c, d_r, page, P=4, B=2, q_len=None, raw=True):
    n = B * P
    shape_q = (B, q_len, H) if q_len else (B, H)
    if raw:
        q = (torch.randn(shape_q + (d_c,)), torch.randn(shape_q + (d_r,)), None)
    else:
        q = (torch.zeros(shape_q + (d_c,), dtype=K.STORAGE[fmt]), torch.randn(shape_q + (d_r,)),
             torch.ones(shape_q))
    pool = (torch.zeros(n, page, d_c, dtype=K.STORAGE[fmt]),
            torch.zeros(n, page, d_r, dtype=torch.bfloat16), torch.ones(n, page),
            torch.arange(n, dtype=torch.int32).reshape(B, P),
            torch.tensor([P * page, 3], dtype=torch.int32))
    return q + pool


@pytest.mark.parametrize("H,page,raw", [(128, 128, True), (32, 64, True), (16, 128, False),
                                        (128, 64, False)])
def test_wrapper_launches_sm90_with_its_entry_point_s_arguments(captured, H, page, raw):
    args = _paged("fp8_e4m3", H, 512, 64, page, raw=raw)
    with pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.25, num_splits=3)
    assert captured["kernel"] == "paged_splitkv_decode_sm90"
    assert captured["fn"] == "snapmla_decode_sm90"
    a = captured["args"]
    assert len(a) == len(_lib._SIGNATURES["snapmla_decode_sm90"]) - 1   # + the stream
    # B, H, n_pages, page, P, num_splits, pages_per_split, softmax_scale
    assert a[15:] == (2, H, 8, page, 4, 3, 2, 0.25)
    assert (a[0] is None) == raw and (a[3] is None) != raw


@pytest.mark.parametrize("case", ["amla", "int8", "none", "verify", "rank4_one_token",
                                  "partials", "d_c_256", "page_256", "page_32"])
def test_wrapper_keeps_the_exact_design_outside_the_route(captured, case):
    fmt = {"int8": "int8", "none": "none"}.get(case, "fp8_e4m3")
    d_c = 256 if case == "d_c_256" else 512
    page = {"page_256": 256, "page_32": 32}.get(case, 128)
    q_len = {"verify": 3, "rank4_one_token": 1}.get(case)
    args = _paged(fmt, 32, d_c, 64, page, q_len=q_len, raw=fmt != "none")
    kw = dict(softmax_scale=0.1, num_splits=2, fmt=fmt,
              rescale="amla" if case == "amla" else "fma",
              return_partials=case == "partials")
    with pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(*args, **kw)
    assert captured["fn"] == "snapmla_decode"
    assert not captured["kernel"].endswith("_sm90")


def test_wrapper_keeps_the_exact_design_for_an_unaligned_query_and_when_pinned(captured):
    args = _paged("fp8_e4m3", 32, 512, 64, 128)
    buf = torch.randn(args[0].numel() + 1)
    unaligned = buf[1:].view(args[0].shape)
    assert unaligned.data_ptr() % 16
    with pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(unaligned, *args[1:], softmax_scale=0.1, num_splits=2)
    assert captured["kernel"] == "paged_splitkv_decode"
    with K.forced_design("exact"), pytest.raises(Launched):
        K.mla_decode_paged_splitkv_cuda(*args, softmax_scale=0.1, num_splits=2)
    assert captured["kernel"] == "paged_splitkv_decode"


def test_contiguous_sink_and_single_pass_wrappers_never_take_sm90(captured):
    q_lat, q_rope, _, content, rope, scale, table, lens = _paged("fp8_e4m3", 32, 512, 64, 128)
    with pytest.raises(Launched):
        K.mla_decode_paged_cuda(q_lat, q_rope, None, content, rope, scale, table, lens,
                                softmax_scale=0.1)
    assert captured["kernel"] == "paged_single_pass_decode"
    B, P = table.shape
    flat = (content[table.long()].reshape(B, P * 128, 512), rope[table.long()].reshape(
        B, P * 128, 64), scale[table.long()].reshape(B, P * 128))
    sink = torch.zeros(B, 4, 512)
    for kw in ({}, {"sink": sink}):
        with pytest.raises(Launched):
            K.mla_decode_splitkv_cuda(q_lat, q_rope, None, *flat, lens, softmax_scale=0.1,
                                      num_splits=2, block_n=128, **kw)
        assert captured["kernel"] == "splitkv_decode"


# (batch, heads, capacity, page, want): the cells' shapes (the pool of
# hi + 16 rounds + 1 positions at contexts up to 32k) and the edges
SPLIT_CASES = [
    (64, 128, 273 * 128, 128, 5),     # dsv3.decode_32k: 128 blocks a split
    (32, 32, 261 * 128, 128, 5),      # mla7b.decode_32k: 32 blocks a split
    (64, 128, 128, 128, 1),           # one page
    (1, 16, 128, 128, 1),
    (1, 16, 273 * 128, 128, 34),      # B = 1: as many splits as 8-page splits allow
    (1, 128, 32768, 64, 64),
    (4, 128, 32768, 128, 17),         # H = 128 at a small batch: cover the SMs
    (256, 128, 32768, 128, 4),        # a large batch: 8k-token splits
    (1024, 128, 2048, 128, 1),        # short rows at a large batch
]


@pytest.mark.parametrize("batch,heads,capacity,page,want", SPLIT_CASES)
def test_sm90_split_rule_at_the_cells_and_the_edges(batch, heads, capacity, page, want):
    assert K.sm90_num_splits(batch, heads, capacity, page, H100_SMS) == want


@pytest.mark.parametrize("batch", (1, 2, 7, 32, 64, 300))
def test_sm90_split_rule_keeps_splits_near_their_length_and_covers_the_sms(batch):
    """Splits of at most SM90_SPLIT_TOKENS tokens and blocks covering the SMs
    where splits of at least SM90_MIN_PAGES pages allow it, and the fewest
    splits that do; never a split below that floor."""
    for heads, pages, page in itertools.product((1, 16, 32, 64, 65, 128),
                                                (1, 7, 8, 64, 273, 1024), (64, 128)):
        capacity = pages * page
        S = K.sm90_num_splits(batch, heads, capacity, page, H100_SMS)
        blocks = batch * -(-heads // K.SM90_HEADS)
        floor = max(1, pages // K.SM90_MIN_PAGES)
        assert 1 <= S <= floor
        if S > 1:
            assert pages // S >= K.SM90_MIN_PAGES
        fits = -(-capacity // S) <= K.SM90_SPLIT_TOKENS and blocks * S >= H100_SMS
        assert fits or S == floor
        if S > 1:   # one split fewer would leave a split too long or an SM idle
            assert (-(-capacity // (S - 1)) > K.SM90_SPLIT_TOKENS
                    or blocks * (S - 1) < H100_SMS)


def _wide(fmt, d_c, q_len=None, B=64, H=128, P=273, page=128):
    """A paged call of the dsv3 cell's shape (B rows of P pages, H heads),
    on a pool of two pages: the rules read shapes, not contents."""
    shape = (B, q_len, H) if q_len else (B, H)
    q = (torch.zeros(shape + (d_c,)), torch.zeros(shape + (64,)), None)
    return q + (torch.zeros(2, page, d_c, dtype=K.STORAGE[fmt]),
                torch.zeros(2, page, 64, dtype=torch.bfloat16), torch.ones(2, page),
                torch.zeros(B, P, dtype=torch.int32), torch.full((B,), 100, dtype=torch.int32))


DESIGN_SPLIT_CASES = [
    (True, "fp8_e4m3", "fma", 512, None, True),
    (False, "fp8_e4m3", "fma", 512, None, False),    # CPU: the plain version's plan
    (True, "fp8_e4m3", "amla", 512, None, False),
    (True, "int8", "fma", 512, None, False),
    (True, "fp8_e4m3", "fma", 256, None, False),
    (True, "fp8_e4m3", "fma", 512, 2, False),
]


@pytest.mark.parametrize("card,fmt,rescale,d_c,q_len,want_sm90", DESIGN_SPLIT_CASES)
def test_design_split_count_only_for_the_calls_sm90_takes(monkeypatch, card, fmt, rescale,
                                                         d_c, q_len, want_sm90):
    monkeypatch.setattr(_lib, "sm_count", lambda index: H100_SMS)
    if card:
        monkeypatch.setattr(K, "_on_cpu", lambda *t: False)
    got = K.design_num_splits(*_wide(fmt, d_c, q_len), fmt=fmt, rescale=rescale)
    assert got == (K.sm90_num_splits(64, 128, 273 * 128, 128, H100_SMS) if want_sm90
                   else None)


@pytest.fixture
def split_calls(monkeypatch):
    """The split count ``ops.snapmla_decode_paged`` hands each wrapper, as
    if its tensors were on the card (the wrappers are not run)."""
    seen = []
    monkeypatch.setattr(K, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(_lib, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K, "mla_decode_paged_splitkv_cuda",
                        lambda *a, num_splits, **kw: seen.append(num_splits) or ("A",))
    monkeypatch.setattr(K, "mla_decode_paged_cuda", lambda *a, **kw: seen.append(1) or ("B",))
    return seen


def _pool_call(fmt, rescale, num_splits, **kw):
    from repro_torch.core.kvcache import PagedMLAPool
    q_lat, q_rope, _, *pool = _wide(fmt, 512, **kw)
    return ops.snapmla_decode_paged(q_lat, q_rope, None, PagedMLAPool(*pool), softmax_scale=0.1,
                                    fmt=fmt, num_splits=num_splits, rescale=rescale)


@pytest.mark.parametrize("rescale,num_splits", [("fma", None), ("fma", 0), ("fma", 3),
                                                ("amla", None)])
def test_paged_decode_takes_the_design_split_count_only_when_unset(split_calls, rescale,
                                                                   num_splits):
    """At the dsv3 cell's shape: an unset count resolves by the sm90 rule
    for a call the design takes, by the exact design's plan otherwise; an
    explicit count is kept."""
    _pool_call("fp8_e4m3", rescale, num_splits)
    want = num_splits or (K.sm90_num_splits(64, 128, 273 * 128, 128, H100_SMS)
                          if rescale == "fma" else
                          ops.resolve_num_splits(None, 273 * 128, 128, 64, "paged", rescale))
    assert split_calls == [want]


def test_paged_decode_sends_one_sm90_split_to_the_single_pass(split_calls):
    """Where the sm90 rule gives one split (a short pool at a small batch)
    the call runs the single pass, as any one-split q_len = 1 call."""
    assert K.sm90_num_splits(4, 32, 5 * 128, 128, H100_SMS) == 1
    assert _pool_call("fp8_e4m3", "fma", None, B=4, H=32, P=5) == ("B",)
    assert split_calls == [1]


def _demangled_name(source: str) -> str:
    """The kernel's name as the profiler shows it, from its declaration:
    namespaces, template arguments at page 128, and the parameter types."""
    assert re.search(r"namespace snap \{\s*namespace sm90 \{", source)
    m = re.search(r"template <([^>]*)>\s*__global__ void (?:__launch_bounds__|__maxnreg__)"
                  r"\([^)]*\)\s*(\w+)\(([^)]*)\)", source)
    assert m, "one __global__ template in the source"
    params, name, args = m.groups()
    kinds = [p.split()[0] for p in params.split(",")]
    assert all(k in ("int", "bool") for k in kinds), kinds
    types = [" ".join(a.replace("__restrict__", "").replace("__grid_constant__", "")
                      .split()[:-1]) for a in args.split(",")]
    return f"void snap::sm90::{name}<128>({', '.join(types)})"


def test_sm90_kernel_name_is_read_as_an_mla_decode_launch_and_not_a_gemm():
    sys.path.insert(0, str(ROOT / "bench" / "metrics"))
    try:
        import _readers
    finally:
        sys.path.remove(str(ROOT / "bench" / "metrics"))
    name = _demangled_name(SM90_SRC.read_text())
    assert "decode_kernel<128>(" in name and "CUtensorMap" in name
    assert re.search(_readers.MLA_DECODE, name)
    assert not re.search(_readers.GEMM, name)
    exact = "void snap::decode_kernel<0, 8, false, false, false, false>(unsigned char const*)"
    assert re.search(_readers.MLA_DECODE, exact) and not re.search(_readers.GEMM, exact)
