"""Frozen counts of the work the program has to do, the yardstick of every
roofline and peak share: a decode call's bytes and operations (a copy of the
port's ``decode_bound`` from chip_smoke.py, taken when the benchmark was
defined) and a whole decode step's. They are functions of the
configuration and the inputs alone, so they read the same work whatever a
later change implements.

Peaks: NVIDIA H100 SXM data sheet, dense rates, 700 W."""
from __future__ import annotations

PEAK = {"fp8_e4m3": 1979e12, "int8": 1979e12, "none": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def decode_bound(lens, fmt, splits, table_entries, heads, d_c=512, d_r=64):
    """Least time (ms, and which bound) of one MLA decode call: the bytes it
    must move (the live tokens' content, rope and scale, the query, the
    page-table entries, the outputs) over HBM bandwidth against its QK + PV
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


def _row_bytes(d: dict, fmt: str) -> int:
    return d["d_c"] * (2 if fmt == "none" else 1) + d["d_rope"] * 2 + 4


def _layer_sizes(d: dict):
    """(MLA weights with the layer's two norm gains, MLA multiply-adds per
    token) of one layer."""
    D, H, dh, dr, dc, r = (d["d_model"], d["n_heads"], d["d_head"], d["d_rope"], d["d_c"],
                           d["q_lora_rank"])
    q_w = D * r + r + r * H * (dh + dr) if r else D * H * (dh + dr)
    q_macs = D * r + r * H * (dh + dr) if r else D * H * (dh + dr)
    kv = D * (dc + dr)
    absorbed = 2 * dc * H * dh + H * dh * D               # W_UK, W_UV, W_O
    return q_w + kv + dc + absorbed + 2 * D, q_macs + kv + absorbed


def _mlp(d: dict, tokens: int, experts_read: float, pairs_kept: float):
    """(weights read, multiply-adds) of one layer's MLP over ``tokens``."""
    D = d["d_model"]
    moe = d["moe"]
    if not moe:
        return 3 * D * d["d_ff"], tokens * 3 * D * d["d_ff"]
    E, f = moe["n_experts"], moe["d_ff_expert"]
    fixed = D * E + 3 * D * f * moe["n_shared_experts"]
    return fixed + experts_read * 3 * D * f, tokens * fixed + pairs_kept * 3 * D * f


def step_work(d: dict, fmt: str, lens, experts_read: float = 0.0, pairs_kept: float = 0.0):
    """float32 FLOPs, attention operations and bytes of one decode step over
    rows that attend ``lens`` tokens each (the new one included): every
    non-expert weight and the experts some token of the step is kept in,
    once; the live latent rows; the appended rows; the logits. For an MoE
    model ``experts_read`` and ``pairs_kept`` are per layer."""
    T, L, D, V = len(lens), d["n_layers"], d["d_model"], d["vocab_size"]
    w_mla, macs_mla = _layer_sizes(d)
    w_mlp, macs_mlp = _mlp(d, T, experts_read, pairs_kept)
    table = V * D * (1 if d["tie"] else 2)
    flops = 2 * (L * (T * macs_mla + macs_mlp) + T * D * V)
    attn = L * sum(lens) * d["n_heads"] * (2 * (d["d_c"] + d["d_rope"]) + 2 * d["d_c"])
    nbytes = (4 * (L * (w_mla + w_mlp) + table + D)
              + L * (sum(lens) + T) * _row_bytes(d, fmt) + T * V * 4)
    return flops, attn, nbytes


def least_seconds(flops: float, attn_ops: float, nbytes: float, fmt: str) -> float:
    """The least time of a step: its operations over the peaks (float32
    matrix work, attention at the cache format's tensor-core rate) or its
    bytes over HBM bandwidth, whichever is larger."""
    return max(flops / PEAK["f32"] + attn_ops / PEAK[fmt], nbytes / HBM_BYTES_PER_S)
