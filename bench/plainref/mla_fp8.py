"""Plain PyTorch reference of an MLA decoder that serves from an FP8 latent
cache, as the SnapMLA paper states its arithmetic. It imports nothing of the
program under test and takes nothing the program made: the weights are the
benchmark's own tensors (``weights`` below), the prompt latents come from the
benchmark's generator, and every quantized byte is worked out again here.

What it computes, per layer (DeepSeek-V2/V3 MLA, paper §2 and §3):

* RMSNorm, the query (direct ``W_UQ`` or q-LoRA ``W_UQ rmsnorm(W_DQ h)``),
  half-split RoPE on the decoupled rope dims, the absorbed latent query
  ``q~ = W_UK^T q_c``;
* the latent KV of every token, ``c = rmsnorm(W_DKV h)`` and
  ``k_r = RoPE(W_KR h)``, stored RoPE-aware per token (Eq. 6): content in
  FP8 e4m3 with one scale ``max(amax, 1e-12) / 448`` per token, the rope
  part divided by that scale and kept in bfloat16;
* decode attention over that store as the paper's FP8 pipeline does it:
  the query quantized the same way per (token, head) (Fused-Q-Quant, rope
  part in float32), QK of the FP8 content summed exactly (float64), P fused
  with the per-token V scale and quantized to FP8 per 128-token block with
  one scale per (row, block) (Eqs. 12-13), the blocks merged by their maxima;
* the output projection ``W_O W_UV``, the residual, the MLP: dense SwiGLU, or
  the token-choice MoE with a softmax router, stable top-k, renormalised
  weights and the capacity rule ``C = max(1, int(T k cf / E))`` (pairs ranked
  within their expert in token order, those at rank >= C dropped), plus the
  shared expert;
* the final RMSNorm and the tied unembedding, float32 logits.

Every float32 matrix product goes through ``mm``, which rounds its operands
to TF32 (10 mantissa bits, nearest even) when ``precision == "tf32"``: that
is the control, the same computation one precision step below float32.
"""
from __future__ import annotations

import math

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
EPS = 1e-12
BLOCK = 128
NORM_EPS = 1e-6


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    b = x.float().contiguous().view(torch.int32)
    low = b & 0x1FFF
    keep = b & ~0x1FFF
    odd = (b >> 13) & 1
    up = (low > 0x1000) | ((low == 0x1000) & (odd == 1))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.name == "tf32":
            a, b = tf32(a), tf32(b)
        return torch.einsum(eq, a, b)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + NORM_EPS) * gain.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE: x [..., S, (H,) d_r] at positions pos [..., S]."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.dim() == pos.dim() + 2:               # a head axis between
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return x.float() * cos + torch.cat([-x2, x1], dim=-1).float() * sin


def quant_rows(x: torch.Tensor):
    """Per-row FP8: (q fp8, scale [...]) with scale = max(amax, EPS) / 448."""
    xf = x.float()
    scale = torch.clamp(torch.amax(xf.abs(), dim=-1), min=EPS) * (1.0 / FP8_MAX)
    q = torch.clamp(xf / scale[..., None], -FP8_MAX, FP8_MAX).to(FP8)
    return q, scale


def store_latents(c: torch.Tensor, k_r: torch.Tensor):
    """The RoPE-aware per-token store of latents c [..., d_c], k_r [..., d_r]:
    (content fp8, rope bf16 divided by the scale, scale f32)."""
    q, scale = quant_rows(c)
    return q, (k_r.float() / scale[..., None]).to(torch.bfloat16), scale


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

class Dims:
    """The widths the reference reads from the configuration."""

    def __init__(self, cfg: dict):
        self.d = cfg["d_model"]
        self.H = cfg["n_heads"]
        self.dh = cfg["d_head"]
        self.dr = cfg["d_rope"]
        self.dc = cfg["d_c"]
        self.q_lora = cfg["q_lora_rank"]
        self.theta = cfg["rope_theta"]
        self.vocab = cfg["vocab_size"]
        self.moe = cfg.get("moe")            # dict or None
        self.block = cfg.get("block", BLOCK)   # P's quantization block (the page)
        self.sm_scale = 1.0 / math.sqrt(self.dh + self.dr)


def latents(w: dict, dims: Dims, h: torch.Tensor, pos: torch.Tensor, P: Precision):
    """h [..., S, d] (already normed) -> c [..., S, d_c], k_r [..., S, d_r]."""
    c = rms_norm(P.mm("...d,dc->...c", h, w["w_dkv"]), w["kv_norm"])
    return c, rope(P.mm("...d,dr->...r", h, w["w_kr"]), pos, dims.theta)


def query(w: dict, dims: Dims, h: torch.Tensor, pos: torch.Tensor, P: Precision):
    """h [B, d] at pos [B] -> (q~ [B, H, d_c], q_r [B, H, d_r])."""
    if dims.q_lora:
        ql = rms_norm(P.mm("bd,dr->br", h, w["w_dq"]), w["q_norm"])
        q = P.mm("br,rhe->bhe", ql, w["w_uq"])
    else:
        q = P.mm("bd,dhe->bhe", h, w["w_uq"])
    q_c, q_r = q[..., :dims.dh], q[..., dims.dh:]
    q_r = rope(q_r[:, None], pos[:, None], dims.theta)[:, 0]
    return P.mm("bhd,chd->bhc", q_c, w["w_uk"]), q_r


def attend(q_lat: torch.Tensor, q_r: torch.Tensor, content: torch.Tensor,
           rope_s: torch.Tensor, scale: torch.Tensor, n: int, sm_scale: float,
           block: int = BLOCK) -> torch.Tensor:
    """One row: q~ [H, d_c], q_r [H, d_r] f32 against the first ``n`` tokens
    of a store (content [N, d_c] fp8, rope [N, d_r] bf16, scale [N]) ->
    o~ [H, d_c] f32, through the FP8 pipeline's arithmetic, P quantized per
    ``block`` tokens."""
    H, dc = q_lat.shape
    nb = -(-n // block)
    N = nb * block
    q8, sq = quant_rows(q_lat)
    qr = q_r.float() / sq[:, None]
    c8, rs, sk = content[:N], rope_s[:N].float(), scale[:N]
    if c8.shape[0] < N:                      # the store ends inside the last block
        pad = N - c8.shape[0]
        c8 = torch.cat([c8, torch.zeros((pad, dc), dtype=c8.dtype, device=c8.device)])
        rs = torch.cat([rs, torch.zeros((pad, rs.shape[1]), device=rs.device)])
        sk = torch.cat([sk, torch.ones((pad,), device=sk.device)])
    cf = c8.float()
    s = (q8.double() @ cf.double().T).float() + (qr.double() @ rs.double().T).float()
    s = s * (sq[:, None] * sk[None, :]) * sm_scale                       # [H, N]
    valid = torch.arange(N, device=s.device) < n
    s = torch.where(valid[None, :], s, float("-inf")).reshape(H, nb, block)
    m = torch.amax(s, dim=-1)                                            # [H, nb]
    e = torch.exp(s - m[..., None])
    pf = e * sk.reshape(nb, block)[None]
    p8, sp = quant_rows(pf)                                              # per (row, block)
    o = torch.einsum("hjk,jkc->hjc", p8.float(), cf.reshape(nb, block, dc)) * sp[..., None]
    l = torch.sum(e, dim=-1)
    wgt = torch.exp(m - torch.amax(m, dim=-1, keepdim=True))            # [H, nb]
    return torch.einsum("hj,hjc->hc", wgt, o) / torch.sum(wgt * l, dim=-1)[:, None]


def out_proj(w: dict, o_lat: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.mm("bhd,hdk->bk", P.mm("bhc,chd->bhd", o_lat, w["w_uv"]), w["w_o"])


# ---------------------------------------------------------------------------
# MLP / MoE / logits
# ---------------------------------------------------------------------------

def dense_mlp(w: dict, h: torch.Tensor, P: Precision) -> torch.Tensor:
    g = torch.nn.functional.silu(P.mm("td,df->tf", h, w["w_gate"]))
    return P.mm("tf,fd->td", g * P.mm("td,df->tf", h, w["w_up"]), w["w_down"])


def route(w: dict, moe: dict, h: torch.Tensor, P: Precision):
    """The MoE routing of tokens h [T, d]: softmax router, stable descending
    top-k, renormalised weights, the capacity rule. Returns (weights [T, k],
    ids [T, k], keep [T, k] bool)."""
    T = h.shape[0]
    E, k = moe["n_experts"], moe["top_k"]
    probs = torch.softmax(P.mm("td,de->te", h, w["w_router"]), dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :k], ids[:, :k]
    if moe.get("renorm_topk", True):
        wts = wts / torch.sum(wts, dim=-1, keepdim=True)
    C = max(1, int(T * k * moe["capacity_factor"] / E))
    onehot = torch.nn.functional.one_hot(ids.reshape(-1), E)            # pairs in token order
    rank = ((torch.cumsum(onehot, dim=0) - 1).gather(1, ids.reshape(-1, 1))[:, 0]).reshape(T, k)
    return wts, ids, rank < C


def moe_mlp(w: dict, moe: dict, h: torch.Tensor, P: Precision):
    """h [T, d] -> (out [T, d], routing (ids, keep))."""
    wts, ids, keep = route(w, moe, h, P)
    out = torch.zeros_like(h, dtype=torch.float32)
    coef = wts * keep
    for e in torch.unique(ids[keep]).tolist():
        t, j = torch.nonzero((ids == e) & keep, as_tuple=True)
        x = h[t]
        y = P.mm("td,df->tf", x, w["w_gate"][e])
        y = torch.nn.functional.silu(y) * P.mm("td,df->tf", x, w["w_up"][e])
        out.index_add_(0, t, P.mm("tf,fd->td", y, w["w_down"][e]) * coef[t, j][:, None])
    if w.get("shared_gate") is not None:
        out = out + dense_mlp({"w_gate": w["shared_gate"], "w_up": w["shared_up"],
                               "w_down": w["shared_down"]}, h, P)
    return out, (ids, keep)


def logits(weights: dict, x: torch.Tensor, P: Precision) -> torch.Tensor:
    table = weights.get("unembed", weights["embed"])
    return P.mm("bd,vd->bv", rms_norm(x, weights["ln_f"]), table)


# ---------------------------------------------------------------------------
# the latent store, one decode step, teacher-forced decode
# ---------------------------------------------------------------------------

class Store:
    """One layer's latent store for R rows of capacity N (fp8 content, bf16
    rope, f32 scale), filled by ``put``."""

    def __init__(self, R: int, N: int, dc: int, dr: int, device):
        self.content = torch.zeros((R, N, dc), dtype=FP8, device=device)
        self.rope = torch.zeros((R, N, dr), dtype=torch.bfloat16, device=device)
        self.scale = torch.ones((R, N), dtype=torch.float32, device=device)

    def put(self, rows: torch.Tensor, pos: torch.Tensor, c: torch.Tensor, k_r: torch.Tensor):
        q, r, s = store_latents(c, k_r)
        self.content[rows, pos] = q
        self.rope[rows, pos] = r
        self.scale[rows, pos] = s


def step(weights: dict, dims: Dims, stores: list, rows: torch.Tensor, tokens: torch.Tensor,
         pos: torch.Tensor, P: Precision, append: bool = True):
    """One decode step of the rows ``rows`` of the stores: each row's input
    token at ``pos``, its latents appended there (unless ``append`` is False,
    where they are already stored), attention over positions 0..pos.
    Returns (logits [R, V], the MoE routing of each layer)."""
    x = weights["embed"][tokens.long()].float()
    routing = []
    for lw, st in zip(weights["layers"], stores):
        h = rms_norm(x, lw["ln1"])
        if append:
            c, k_r = latents(lw["mla"], dims, h[:, None], pos[:, None], P)
            st.put(rows, pos, c[:, 0], k_r[:, 0])
        q_lat, q_r = query(lw["mla"], dims, h, pos, P)
        o = torch.stack([attend(q_lat[i], q_r[i], st.content[b], st.rope[b], st.scale[b],
                                int(pos[i]) + 1, dims.sm_scale, dims.block)
                         for i, b in enumerate(rows.tolist())])
        x = x + out_proj(lw["mla"], o, P)
        h2 = rms_norm(x, lw["ln2"])
        if dims.moe:
            y, rt = moe_mlp(lw["mlp"], dims.moe, h2, P)
            routing.append(rt)
        else:
            y = dense_mlp(lw["mlp"], h2, P)
        x = x + y
    return logits(weights, x, P), routing


def decode(weights: dict, cfg: dict, prompt_latents, ctx: torch.Tensor, tokens: torch.Tensor,
           check: list[int], precision: str = "float32", latent_block: int = 4096):
    """Teacher-forced decode of R rows (all rows of the batch for an MoE
    model, whose capacity rule couples them).

    ``ctx`` [R] the prompt lengths; ``prompt_latents(layer, t0, t1)`` gives
    the float32 latents (c [R, t1-t0, d_c], k_r [R, t1-t0, d_r]) of prompt
    positions t0..t1-1 of every row (positions past a row's prompt are
    ignored); ``tokens`` [R, S] the input token of each step, step s at
    position ctx + s. Returns (logits [len(check), R, V] at the steps
    ``check``, the routing of each checked step).

    A one-layer model's step inputs are its embeddings, so every appended
    latent is computed up front and only the checked steps are run; a deeper
    model runs every step up to the last checked one."""
    dims = Dims(cfg)
    P = Precision(precision)
    dev = tokens.device
    R = tokens.shape[0]
    last = max(check)
    hi = int(ctx.max())
    rows = torch.arange(R, device=dev)
    stores = []
    for li in range(len(weights["layers"])):
        st = Store(R, hi + last + 1, dims.dc, dims.dr, dev)
        for t0 in range(0, hi, latent_block):
            t1 = min(t0 + latent_block, hi)
            c, k_r = prompt_latents(li, t0, t1)
            st.content[:, t0:t1], st.rope[:, t0:t1], st.scale[:, t0:t1] = store_latents(c, k_r)
            del c, k_r
        stores.append(st)
    pos_all = ctx.long()[:, None] + torch.arange(last + 1, device=dev)[None, :]
    one_layer = len(weights["layers"]) == 1
    if one_layer:
        # layer 0's appended latents depend on the tokens alone
        lw = weights["layers"][0]
        h0 = rms_norm(weights["embed"][tokens[:, :last + 1].long()], lw["ln1"])
        c, k_r = latents(lw["mla"], dims, h0, pos_all, P)
        stores[0].put(rows[:, None].expand(R, last + 1), pos_all, c, k_r)
    out, routing = [], []
    for s in (sorted(set(check)) if one_layer else range(last + 1)):
        lg, rt = step(weights, dims, stores, rows, tokens[:, s], pos_all[:, s], P,
                      append=not one_layer)
        if s in check:
            out.append(lg)
            routing.append(rt)
    return torch.stack(out), routing
