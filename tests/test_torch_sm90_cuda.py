"""The sm90 design of kernel A (``csrc/mla_decode_sm90.cu``: 64 heads a CUDA
block, fp8 wgmma for QK and PV, float32 sums promoted every k32 step)
against the plain version (``ref.py``) on the card: 128 and 32 heads (and
16, a group mostly padding), pages of 64 and 128, raw and prepared queries,
ragged rows (empty, one token, shorter than one split, ending on a page
edge), empty splits, page tables out of order, the cells' batch and context
range; its tickets and repeated launches; and whole models at each cell's
configuration through the fused decode loop, against the exact design.
Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sm90_cuda.py

Tolerances. The design sums in float32, in other orders than the plain
version's float64 QK, and the fp8 tensor core keeps fewer bits than float32
inside one instruction's sum, so a logit moves in its last bits (about
2^-13 of the sum of its products' magnitudes, A below). P's fp8 rounding
turns such a move into one fp8 step of a P entry where p~ / sigma_p lies
near a rounding edge, where the plain version's own rounding error is half
a step. So, per (row, head):

  * o within three times the plain version's own P8 error (its o against
    the same softmax in float64 with P unrounded), plus 2^-9 of |o| for the
    sums and the logits' move through l, in the 2-norm over d_c; and the
    mean of |o - o_plain| / |o_plain| over the live (row, head) under 2^-8
    (the design reads ~3e-4). A PV fault (a permuted gather, a missed
    rescale of the running sum) fails this: ``test_check_fails_on_planted_pv_faults``;
  * lse, which P's rounding does not enter, within the logits' move:
    2^-12 max_t A_t, A_t = (|q| . |c_t| + |q_r| . |r_t|) sigma_q sigma_k
    scale; an empty row's (0, the plain version's lse) exactly.
"""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.kvcache import CacheConfig, mla_quantize_entry
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.kernels.mla_decode import ref as R
from repro_torch.launch import serve
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda
SCALE = 0.1


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    _lib.lib()
    return torch.device("cuda")


def _case(lens, P, page, H, seed, raw=True):
    """A shuffled fp8 pool of B * P + 2 pages at the MLA widths, its page
    table and a query of H heads (raw, or prepared by ``prepare_q``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, n_pool = len(lens), len(lens) * P + 2
    c = torch.randn(n_pool * page, 512, generator=g, device="cuda")
    r = torch.randn(n_pool * page, 64, generator=g, device="cuda") * 2
    content, rope, scale = mla_quantize_entry(CacheConfig(fmt="fp8_e4m3", page_size=page), c, r)
    table = torch.randperm(n_pool, generator=g, device="cuda")[: B * P].reshape(B, P)
    pool = (content.reshape(n_pool, page, 512), rope.reshape(n_pool, page, 64),
            scale.reshape(n_pool, page), table.int().contiguous(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))
    q = (torch.randn(B, H, 512, generator=g, device="cuda"),
         torch.randn(B, H, 64, generator=g, device="cuda"))
    prepared = R.prepare_q(*q, "fp8_e4m3")
    return (q + (None,) if raw else prepared), prepared, pool


def _rows(prepared, pool):
    """Each live row's plain logits in float64, from the prepared query:
    (b, s [H, n], A [H, n] (the magnitudes of s's products), the values
    sigma_k c [n, d_c], the pages' token counts)."""
    q8, q_r, sq = prepared
    content, rope, sk, table, lens = pool
    page = content.shape[1]
    for b in range(q8.shape[0]):
        n = int(lens[b])
        if n == 0:
            continue
        pages = table[b, : -(-n // page)].long()
        c = content[pages].reshape(-1, 512)[:n].double()
        r = rope[pages].reshape(-1, 64)[:n].double()
        k = sk[pages].reshape(-1)[:n].double()
        qd, qrd = q8[b].double(), q_r[b].double()
        f = sq[b].double()[:, None] * k[None, :] * SCALE
        yield (b, (qd @ c.T + qrd @ r.T) * f, (qd.abs() @ c.abs().T + qrd.abs() @ r.abs().T) * f,
               c * k[:, None])


def _bounds(prepared, pool, o_ref):
    """The per-(row, head) tolerances of the module note: (o_tol [B, H],
    lse_tol [B, H])."""
    B, H = o_ref.shape[:2]
    o_tol = torch.zeros(B, H, dtype=torch.float64, device="cuda")
    lse_tol = torch.zeros_like(o_tol)
    for b, s, a, v in _rows(prepared, pool):
        exact = torch.softmax(s, -1) @ v
        ref = o_ref[b].double()
        o_tol[b] = 3 * (ref - exact).norm(dim=-1) + 2.0 ** -9 * ref.norm(dim=-1)
        lse_tol[b] = 2.0 ** -12 * a.max(-1).values
    return o_tol, lse_tol


def _check(o, lse, o_ref, lse_ref, prepared, pool):
    """(the worst o error over its tolerance, the mean relative o error, the
    worst lse error over its tolerance)."""
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o_tol, lse_tol = _bounds(prepared, pool, o_ref)
    o_err = (o - o_ref).double().norm(dim=-1)
    lse_err = (lse - lse_ref).abs().double()
    empty = pool[4] == 0
    assert torch.equal(o[empty], torch.zeros_like(o[empty]))
    assert torch.equal(lse[empty], lse_ref[empty])
    live = ~empty
    o_ratio = (o_err / o_tol.clamp_min(1e-30))[live]
    rel = (o_err / o_ref.double().norm(dim=-1).clamp_min(1e-30))[live]
    lse_ratio = (lse_err / lse_tol.clamp_min(1e-30))[live]
    assert (o_ratio <= 1).all(), float(o_ratio.max())
    assert float(rel.mean()) <= 2.0 ** -8, float(rel.mean())
    assert (lse_ratio <= 1).all(), float(lse_ratio.max())
    return float(o_ratio.max()), float(rel.mean()), float(lse_ratio.max())


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("H", [128, 32, 16])
@pytest.mark.parametrize("page", [128, 64])
def test_sm90_matches_plain_on_ragged_rows(cuda, page, H, raw):
    """Rows empty, of one token, ending on a page edge and one past it,
    shorter than one split, and full, over 1 to 8 splits (empty splits in
    most rows): the one launch of the sm90 design, within the tolerances."""
    P = 8
    lens = [0, 1, page, page + 1, 2 * page - 1, 3 * page + 17, P * page - 5, P * page]
    q, prepared, pool = _case(lens, P, page, H, seed=page + H + raw, raw=raw)
    for S in (1, 2, 3, 5, 8):
        _lib.reset_launches()
        o, lse = K.mla_decode_paged_splitkv_cuda(*q, *pool, softmax_scale=SCALE, num_splits=S)
        assert dict(_lib.LAUNCHES) == {"paged_splitkv_decode_sm90": 1}
        o_ref, lse_ref = R.snapmla_decode_paged_splitkv_ref(
            *prepared, *pool, softmax_scale=SCALE, num_splits=S, fmt="fp8_e4m3")
        _check(o, lse, o_ref, lse_ref, prepared, pool)


def _pv_fault(prepared, pool, o_ref, fault):
    """The plain output with one PV fault planted, single split: "gather"
    reads each 16-token group of a page in the k-slot order (slot 4x + y
    holds token x + 4y) as if it were the token order; "corr" adds each
    page's PV at the running maximum of its own page without rescaling the
    sum before it (l is rescaled). The softmax's own P8 error is kept."""
    out = o_ref.clone()
    page = pool[0].shape[1]
    for b, s, _, v in _rows(prepared, pool):
        w = torch.softmax(s, -1)
        if fault == "gather":
            n = v.shape[0] - v.shape[0] % 16
            idx = torch.arange(v.shape[0], device=v.device)
            i = idx[:n] % 16
            idx[:n] += i % 4 * 4 + i // 4 - i
            bad = w @ v[idx]
        else:
            acc = torch.zeros(s.shape[0], v.shape[1], dtype=s.dtype, device=s.device)
            m = torch.full((s.shape[0], 1), float("-inf"), dtype=s.dtype, device=s.device)
            l = torch.zeros_like(m)
            for t0 in range(0, s.shape[1], page):
                sp, vp = s[:, t0:t0 + page], v[t0:t0 + page]
                m_new = torch.maximum(m, sp.max(-1, keepdim=True).values)
                e = torch.exp(sp - m_new)
                acc = acc + e @ vp                      # the fault: no acc * exp(m - m_new)
                l = l * torch.exp(m - m_new) + e.sum(-1, keepdim=True)
                m = m_new
            bad = acc / l
        out[b] = (o_ref[b].double() - w @ v + bad).float()
    return out


@pytest.mark.parametrize("fault", ["gather", "corr"])
def test_check_fails_on_planted_pv_faults(cuda, fault):
    """The o tolerance is tight enough to see a PV fault: the plain output
    passes ``_check``; the same output with a fault planted fails it."""
    P, page = 8, 128
    lens = [0, 1, page + 1, 2 * page - 1, 3 * page + 17, P * page - 5, P * page, 5 * page]
    q, prepared, pool = _case(lens, P, page, 32, seed=11)
    o_ref, lse_ref = R.snapmla_decode_paged_splitkv_ref(
        *prepared, *pool, softmax_scale=SCALE, num_splits=1, fmt="fp8_e4m3")
    _check(o_ref, lse_ref, o_ref, lse_ref, prepared, pool)
    with pytest.raises(AssertionError):
        _check(_pv_fault(prepared, pool, o_ref, fault), lse_ref, o_ref, lse_ref, prepared,
               pool)


@pytest.mark.parametrize("batch,H", [(64, 128), (32, 32)])
def test_sm90_matches_plain_at_the_cells_shapes(cuda, batch, H):
    """The cells' batch and contexts (16,384-32,768 tokens, a pool of 273
    pages a row) at the split count the sm90 rule gives them."""
    g = torch.Generator().manual_seed(batch)
    lens = torch.randint(16384, 32769, (batch,), generator=g).tolist()
    P, page = 273, 128
    q, prepared, pool = _case(lens, P, page, H, seed=7)
    S = K.sm90_num_splits(batch, H, P * page, page, _lib.sm_count(0))
    o, lse = K.mla_decode_paged_splitkv_cuda(*q, *pool, softmax_scale=SCALE, num_splits=S)
    o_ref, lse_ref = R.snapmla_decode_paged_splitkv_ref(
        *prepared, *pool, softmax_scale=SCALE, num_splits=S, fmt="fp8_e4m3")
    _check(o, lse, o_ref, lse_ref, prepared, pool)


def test_sm90_repeats_its_bits_and_leaves_the_tickets_at_zero(cuda):
    """Back-to-back launches, with the exact design's folded launch between
    them on the shared scratch, give the same bits; every ticket reads 0."""
    q, _, pool = _case([300, 1000, 0, 777], 8, 128, 128, seed=5)
    first = K.mla_decode_paged_splitkv_cuda(*q, *pool, softmax_scale=SCALE, num_splits=4)
    with K.forced_design("exact"):
        K.mla_decode_paged_splitkv_cuda(*q, *pool, softmax_scale=SCALE, num_splits=3)
    second = K.mla_decode_paged_splitkv_cuda(*q, *pool, softmax_scale=SCALE, num_splits=4)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    tickets = K._SCRATCH.tickets(torch.device("cuda", torch.cuda.current_device()), 1)
    assert int(torch.count_nonzero(tickets)) == 0


# (arch, layers, batch, the cell's logit_dev_mean limit); deepseek's batch
# of 64 leaves no room for its prefill's MoE beside 50 GB of weights
MODELS = [("deepseek-v3-mla", 1, 16, 0.018), ("mla-7b", 30, 32, 0.05)]


@contextlib.contextmanager
def _routing(monkeypatch, calls):
    """Append each MoE call's routing to ``calls``: (ids [T, k], keep [T, k]
    in token order: the capacity rule's drops)."""
    from repro_torch.models import moe
    route, dispatch = moe._route, moe._dispatch

    def routed(params, cfg, xt):
        weights, ids = route(params, cfg, xt)
        calls.append([ids.clone()])
        return weights, ids

    def dispatched(xt, ids, E, C, k):
        out = dispatch(xt, ids, E, C, k)
        keep = torch.empty_like(out[2])
        keep[out[3]] = out[2]
        calls[-1].append(keep.reshape(ids.shape))
        return out

    with monkeypatch.context() as m:
        m.setattr(moe, "_route", routed)
        m.setattr(moe, "_dispatch", dispatched)
        yield


def _same_route(calls, calls_e, batch, steps):
    """[batch, steps + 1]: row b's routing at decode step j (logits j) the
    same in both runs, in every layer (column 0, the prefill: True)."""
    dec = [c for c in calls if c[0].shape[0] == batch]
    dec_e = [c for c in calls_e if c[0].shape[0] == batch]
    assert len(dec) == len(dec_e) and len(dec) % steps == 0, (len(dec), len(dec_e))
    same = torch.ones(batch, steps + 1, dtype=torch.bool, device="cuda")
    per_step = len(dec) // steps
    for i, ((ids, keep), (ids_e, keep_e)) in enumerate(zip(dec, dec_e)):
        same[:, 1 + i // per_step] &= ((ids == ids_e) & (keep == keep_e)).all(-1)
    return same


@pytest.mark.parametrize("arch,layers,batch,limit", MODELS)
def test_whole_model_on_the_fused_path_through_sm90(cuda, monkeypatch, arch, layers, batch,
                                                    limit):
    """Each cell's configuration at a short context (prompts of 300 tokens,
    2 splits): through ``generate_fused`` every layer's decode launch in the
    captured step is the sm90 design's and none the exact design's, and its
    tokens are the step loop's; the step loop's greedy logits against the
    same loop on the exact design (the plain version's bits), as the cell
    reads them: the widest logit difference over the logits' standard
    deviation (``logit_dev``), its mean under the cell's limit, over the
    positions whose history both runs share. An MoE position also needs the
    same routing in both runs (top-k and capacity drops, every layer, this
    step and before): a router near-tie sends a token to other experts and
    moves its whole logits row, which says nothing of the attention."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, kv_paged=True, kv_splits=2,
                              page_size=128, kv_fmt="fp8_e4m3", kv_rescale="fma",
                              decode_backend="kernel", use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_model(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, 300), generator=gen, device="cuda")
    steps = 5
    try:
        _lib.reset_launches()
        stats = {}
        toks_f, _, _ = serve.generate_fused(cfg, params, prompts, steps + 1,
                                            return_logits=True, stats=stats)
        assert _lib.CAPTURED["paged_splitkv_decode_sm90"] == layers
        assert stats["replays"] >= 1
        decode = {k for k in (*_lib.LAUNCHES, *_lib.CAPTURED) if "decode" in k}
        assert decode == {"paged_splitkv_decode_sm90"}, decode
        calls, calls_e = [], []
        with _routing(monkeypatch, calls):
            toks, _, logits = serve.generate(cfg, params, prompts, steps + 1,
                                             return_logits=True)
        assert torch.equal(toks, toks_f)
        with K.forced_design("exact"), _routing(monkeypatch, calls_e):
            toks_e, _, logits_e = serve.generate(cfg, params, prompts, steps + 1,
                                                 return_logits=True)
        routed = (_same_route(calls, calls_e, batch, steps) if cfg.moe is not None else
                  torch.ones(batch, steps + 1, dtype=torch.bool, device="cuda"))
        same = torch.ones(batch, dtype=torch.bool, device="cuda")
        devs, dropped = [], 0
        for j in range(1, steps + 1):   # logits j: the decode step on token j - 1
            same &= toks[:, j - 1] == toks_e[:, j - 1]
            dropped += int((same & ~routed[:, j]).sum())
            same &= routed[:, j]
            d = (logits[:, j] - logits_e[:, j]).abs().amax(-1) / logits_e[:, j].std(-1)
            devs.append(d[same])
        devs = torch.cat(devs)
        reading = dict(mean=float(devs.mean()), max=float(devs.max()), positions=devs.numel(),
                       dropped_for_routing=dropped)
        print(f"{arch} logit_dev {reading}")
        assert devs.numel() >= batch, reading
        assert reading["mean"] < limit, reading
    finally:
        del params
        torch.cuda.empty_cache()
