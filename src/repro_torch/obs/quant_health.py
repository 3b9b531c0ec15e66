"""Opt-in FP8 quantization health probes over the live paged KV pool (port of
``repro/obs/quant_health.py``).

SnapMLA stores the content half of every KV entry quantized per token
(scale = amax / qmax). This module samples the RUNNING engine's pool, so a
serving workload whose scale distribution drifts (or whose clip rate climbs)
is visible before tokens degrade. Sampling is opt-in and periodic
(``serve --quant-health-every N``, default off); the probe only reads the
pool, so greedy tokens are identical with probes on or off.

Per pool layer, over written rows only (scale > 0): ``scale_min`` /
``scale_max`` and a log2-exponent histogram of the per-token scales, the
``clip_rate`` (fraction of stored content elements with |code| >= qmax), and
``sink_err_bound_max`` — ``scale * qmax * rel_step / 2`` over the sink rows
(token 0 of each live sequence).

Where the work runs: the reference copies every pool layer to the host as
float32 (quant_health.py:105-108: 2.47 MB per resident mla-7b page). Here
the content planes are reduced on the device — one clipped-element count per
layer — and ONE device-to-host copy per sample brings back those counts with
the resident pages' scales (4 B per row) and the sink rows' scales. The
statistics are then computed on the host with the reference's own numpy
float32 arithmetic: ``floor(log2(scale))`` in particular is numpy's float32
``log2`` (a device ``log2`` may round one ulp apart just below a power of
two and bin the row one exponent higher). Every statistic is a min, max,
count or floor, so on the same pool bytes the report equals the reference's
exactly.

The port's decode state holds one pool per layer in a list, where the
reference holds the same layers as one scanned (stacked) leaf: layer ``i``
is reported under the reference's key ``pool0.{i}``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import qmax_for

# log2(scale) exponent histogram range (clamped): 2^-24 .. 2^8
_EXP_LO, _EXP_HI = -24, 8


def _rel_step(fmt: str) -> float:
    """Worst-case relative grid spacing of the storage format."""
    if fmt == "fp8_e4m3":
        return 2.0 ** -3          # e4m3: 3 mantissa bits
    return 1.0 / qmax_for(fmt)    # int8: uniform grid


def _layer_stats(s: np.ndarray, sink_s: np.ndarray, clipped: int, d_c: int,
                 qmax: float, rel_step: float) -> dict[str, Any]:
    """Health stats for ONE pool layer from its resident pages' scales ``s``
    [P, page] (float32), its sink rows' scales ``sink_s`` [n_sinks] and the
    device's count of clipped content elements in written rows."""
    written = s > 0.0
    n_written = int(written.sum())
    out: dict[str, Any] = {"written_rows": n_written}
    if n_written == 0:
        out.update(scale_min=0.0, scale_max=0.0, clip_rate=0.0,
                   scale_exp_hist={}, sink_rows=0, sink_scale_max=0.0,
                   sink_err_bound_max=0.0)
        return out
    sw = s[written]
    out["scale_min"] = float(sw.min())
    out["scale_max"] = float(sw.max())
    exps = np.clip(np.floor(np.log2(sw)).astype(np.int64), _EXP_LO, _EXP_HI)
    uniq, counts = np.unique(exps, return_counts=True)
    out["scale_exp_hist"] = {str(int(e)): int(n) for e, n in zip(uniq, counts)}
    out["clip_rate"] = clipped / float(n_written * d_c)
    if sink_s.size:
        sink_live = sink_s > 0.0
        out["sink_rows"] = int(sink_live.sum())
        smax = float(sink_s[sink_live].max()) if sink_live.any() else 0.0
        out["sink_scale_max"] = smax
        out["sink_err_bound_max"] = smax * qmax * rel_step / 2.0
    else:
        out.update(sink_rows=0, sink_scale_max=0.0, sink_err_bound_max=0.0)
    return out


def probe_pools(pools, *, fmt: str, resident_pages, sink_pages) -> dict[str, Any]:
    """Sample every layer's pool (``PagedMLAPool``s, one per layer) and
    return the per-layer health report plus an aggregate."""
    qmax = qmax_for(fmt)
    rel = _rel_step(fmt)
    pools = list(pools)
    pages = np.asarray(sorted(resident_pages), np.int64)
    sinks = np.asarray(sorted(sink_pages), np.int64)
    layers: dict[str, dict] = {}
    if pools:
        dev = pools[0].scale.device
        p_idx = torch.as_tensor(pages, device=dev)
        s_idx = torch.as_tensor(sinks, device=dev)
        parts = []
        for pool in pools:
            s = pool.scale[p_idx]
            written = (s > 0.0)[..., None]
            clipped = ((pool.content[p_idx].float().abs() >= qmax) & written).sum()
            parts += [s.double().flatten(), pool.scale[s_idx, 0].double(),
                      clipped.double().reshape(1)]
        host = torch.cat(parts).cpu().numpy()          # the sample's one transfer
        page, d_c = pools[0].content.shape[1:]
        n_s, n_k = pages.size * page, sinks.size
        for i in range(len(pools)):
            row = host[i * (n_s + n_k + 1):(i + 1) * (n_s + n_k + 1)]
            layers[f"pool0.{i}"] = _layer_stats(
                row[:n_s].astype(np.float32).reshape(pages.size, page),
                row[n_s:n_s + n_k].astype(np.float32), int(row[-1]), d_c, qmax, rel)
    agg = {
        "resident_pages": int(pages.size),
        "scale_min": min((v["scale_min"] for v in layers.values()
                          if v["written_rows"]), default=0.0),
        "scale_max": max((v["scale_max"] for v in layers.values()), default=0.0),
        "clip_rate_max": max((v["clip_rate"] for v in layers.values()),
                             default=0.0),
        "sink_err_bound_max": max((v["sink_err_bound_max"]
                                   for v in layers.values()), default=0.0),
    }
    return {"fmt": fmt, "layers": layers, "aggregate": agg}


class QuantHealthProbe:
    """Periodic sampler bound to a registry: every ``every`` engine steps,
    probe the pool and push the aggregate into gauges. Reports accumulate
    in ``self.samples`` for the JSON event log."""

    def __init__(self, registry, *, fmt: str, every: int):
        if every <= 0:
            raise ValueError("quant-health sampling period must be > 0")
        self.fmt = fmt
        self.every = int(every)
        self.samples: list[dict] = []
        self._scale_min = registry.gauge(
            "snapmla_quant_scale_min", "min per-token KV scale (written rows)")
        self._scale_max = registry.gauge(
            "snapmla_quant_scale_max", "max per-token KV scale (written rows)")
        self._clip_rate = registry.gauge(
            "snapmla_quant_clip_rate_max",
            "max per-layer fraction of content elements saturated at qmax")
        self._sink_err = registry.gauge(
            "snapmla_quant_sink_err_bound_max",
            "analytic max quantization error bound over sink rows")
        self._samples = registry.counter(
            "snapmla_quant_samples_total", "quant-health probes taken")

    def due(self, step: int) -> bool:
        return step % self.every == 0

    def sample(self, step: int, pools, *, resident_pages, sink_pages) -> dict[str, Any]:
        report = probe_pools(pools, fmt=self.fmt, resident_pages=resident_pages,
                             sink_pages=sink_pages)
        agg = report["aggregate"]
        self._scale_min.set(agg["scale_min"])
        self._scale_max.set(agg["scale_max"])
        self._clip_rate.set(agg["clip_rate_max"])
        self._sink_err.set(agg["sink_err_bound_max"])
        self._samples.inc()
        self.samples.append({"step": step, **agg})
        return report
