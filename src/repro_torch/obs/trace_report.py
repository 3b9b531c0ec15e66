"""Summarize a SnapMLA Chrome trace (``serve --trace-out``) in the terminal
(the port's copy of ``scripts/trace_report.py``):

    PYTHONPATH=src python -m repro_torch.obs.trace_report trace.json \
        [--expect-requests N]

Validates the file first (``repro_torch.obs.trace.validate_chrome_trace``; pass
``--expect-requests`` to also pin the request-track count, as ci_smoke
does), then prints three tables derived purely from the trace:

  * per-request lifecycle — queued/admitted/first-token/terminal steps,
    TTFT and latency in engine steps (virtual clock: ``ts //
    ticks_per_step`` recovers the exact step, so these EQUAL the engine's
    own reported numbers), prefill chunk count, outcome;
  * decode-stall — engine steps whose prefill window ran while decodes
    were in flight (the ITL-spike steps), with per-step token maxima;
  * page occupancy — min/mean/peak of the per-step pool counter samples;
  * speculative decoding (``serve --spec-draft``) — verify steps, drafted
    vs accepted totals, and the acceptance rate, from the verify-flagged
    decode phase spans.

Exit code is non-zero on validation failure, so CI can gate on it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.obs.trace import ENGINE_PID, validate_chrome_trace

_TERMINAL = ("DONE", "FAILED", "REJECTED")


def _fmt_table(headers: list[str], rows: list[list[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.rjust(w) for c, w in zip(cells, widths))
    return "\n".join([line(headers), line(["-" * w for w in widths])]
                     + [line(r) for r in rows])


def summarize(payload: dict) -> dict:
    """Pure extraction (no printing): the per-request, stall, and occupancy
    summaries as plain dicts — tests consume this, main() renders it."""
    meta = payload.get("metadata", {})
    virtual = meta.get("clock", "virtual") == "virtual"
    ticks = int(meta.get("ticks_per_step", 1000))

    def step_of(ts: int) -> int:
        return ts // ticks if virtual else ts

    reqs: dict[int, dict] = {}
    stall_steps: dict[int, dict] = {}
    pages: list[dict] = []
    spec = {"verify_steps": 0, "drafted": 0, "accepted": 0, "rows": 0}
    for e in payload["traceEvents"]:
        ph = e.get("ph")
        if ph == "M":
            continue
        if e.get("pid") == ENGINE_PID:
            if ph == "C" and e.get("name") == "pages":
                pages.append(e["args"])
            elif ph == "X" and e.get("name") == "prefill" \
                    and e["args"].get("stalled_decodes", 0) > 0:
                stall_steps[e["args"]["step"]] = {
                    "tokens": e["args"].get("tokens", 0),
                    "stalled_decodes": e["args"]["stalled_decodes"]}
            elif ph == "X" and e.get("name") == "decode" \
                    and e.get("args", {}).get("verify"):
                spec["verify_steps"] += 1
                spec["drafted"] += e["args"].get("drafted", 0)
                spec["accepted"] += e["args"].get("accepted", 0)
                spec["rows"] += e["args"].get("rows", 0)
            continue
        rid = e.get("tid")
        r = reqs.setdefault(rid, {"rid": rid, "queued": None, "admit": None,
                                  "first_token": None, "end": None,
                                  "outcome": "?", "chunks": 0,
                                  "prompt_len": None, "evictions": 0})
        name, ts = e.get("name", ""), e["ts"]
        if ph == "X":
            if name == "QUEUED" and r["queued"] is None:
                r["queued"] = step_of(ts)
                r["prompt_len"] = e["args"].get("prompt_len")
            elif name == "PREFILL" and r["admit"] is None:
                r["admit"] = step_of(ts)
            elif name.startswith("PREFILL(chunk"):
                r["chunks"] += 1
        elif ph == "i":
            if name == "FIRST_TOKEN" and r["first_token"] is None:
                r["first_token"] = step_of(ts)
            elif name == "EVICTED":
                r["evictions"] += 1
            elif any(name.startswith(t) for t in _TERMINAL):
                r["end"], r["outcome"] = step_of(ts), name
    for r in reqs.values():
        q, ft, end = r["queued"], r["first_token"], r["end"]
        r["ttft"] = ft - q if virtual and None not in (q, ft) else None
        r["latency"] = end - q if virtual and None not in (q, end) else None
    occupancy = {}
    if pages:
        in_use = [p["in_use"] for p in pages]
        cap = [p["in_use"] + p["free"] for p in pages]
        occupancy = {
            "samples": len(pages),
            "in_use_min": min(in_use),
            "in_use_mean": sum(in_use) / len(in_use),
            "in_use_peak": max(in_use),
            "cached_peak": max(p.get("cached", 0) for p in pages),
            "capacity": max(cap),
        }
    stalls = sorted(stall_steps.items())
    spec["accept_rate"] = (spec["accepted"] / spec["drafted"]
                           if spec["drafted"] else 0.0)
    return {
        "clock": meta.get("clock", "virtual"),
        "requests": [reqs[rid] for rid in sorted(reqs)],
        "stall": {
            "steps": len(stalls),
            "tokens_total": sum(s["tokens"] for _, s in stalls),
            "tokens_per_step_max": max((s["tokens"] for _, s in stalls),
                                       default=0),
            "by_step": stalls,
        },
        "occupancy": occupancy,
        "speculative": spec,
    }


def render(summary: dict, stats: dict) -> str:
    unit = "step" if summary["clock"] == "virtual" else "us"
    out = [f"trace: {stats['events']} events, {stats['spans']} spans, "
           f"{stats['requests']} request tracks "
           f"({summary['clock']} clock, times in {unit}s)", ""]
    rows = []
    for r in summary["requests"]:
        def s(v):
            return "-" if v is None else str(v)
        rows.append([s(r["rid"]), s(r["prompt_len"]), s(r["queued"]),
                     s(r["admit"]), s(r["first_token"]), s(r["ttft"]),
                     s(r["end"]), s(r["latency"]), s(r["chunks"]),
                     s(r["evictions"]), r["outcome"]])
    out.append(_fmt_table(
        ["rid", "prompt", "queued", "admit", "first_tok", "ttft", "end",
         "latency", "chunks", "evict", "outcome"], rows))
    st = summary["stall"]
    out += ["", f"decode stall: {st['steps']} stalled steps, "
            f"{st['tokens_total']} prefill tokens alongside live decodes, "
            f"max {st['tokens_per_step_max']} tokens/step"]
    occ = summary["occupancy"]
    if occ:
        out += ["", f"pages: peak {occ['in_use_peak']}/{occ['capacity']} "
                f"in use (mean {occ['in_use_mean']:.1f}, "
                f"min {occ['in_use_min']}, cached peak "
                f"{occ['cached_peak']}) over {occ['samples']} step samples"]
    sp = summary["speculative"]
    if sp["verify_steps"]:
        out += ["", f"speculative: {sp['verify_steps']} verify steps over "
                f"{sp['rows']} slot-steps, drafted {sp['drafted']} / "
                f"accepted {sp['accepted']} "
                f"(accept rate {sp['accept_rate']:.3f})"]
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace JSON from serve --trace-out")
    ap.add_argument("--expect-requests", type=int, default=None,
                    help="fail unless the trace has exactly this many "
                    "request tracks, each with one terminal instant")
    args = ap.parse_args()
    payload = json.loads(pathlib.Path(args.trace).read_text())
    try:
        stats = validate_chrome_trace(payload,
                                      expect_requests=args.expect_requests)
    except ValueError as err:
        print(f"[trace_report] INVALID {args.trace}: {err}",
              file=sys.stderr)
        return 1
    print(render(summarize(payload), stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
