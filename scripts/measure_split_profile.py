#!/usr/bin/env python3
"""Measure the port's split profile on one NVIDIA GPU and write it as JSON.

    python3 scripts/measure_split_profile.py [--out H100_splits_profile.json]

Sweeps the CUDA decode kernels (``repro_torch.kernels.mla_decode.autotune.
measure_split_sweep``: single pass at one split, split-KV above, each
candidate split count timed as CUDA-graph replays between CUDA events) at
block 128, batch 4, d_c 512, d_r 64, on the contiguous cache and the paged
pool, FMA and AMLA:

  * the serving shape of mla-7b and deepseek-v3-mla (a 512-token prompt +
    16 generated: capacity 640, 528 tokens per row);
  * 32k (capacity 32,768, every row full).

The profile's keys are the reference's (capacity / block_n / batch, the
layout and rescale suffixes); they carry no head count. Each entry's plan
comes from mla-7b's 32 heads; the same sweep at deepseek-v3-mla's 128 heads
is kept beside it, in the entry's ``by_heads``, and plans nothing. The file
records the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them. Prints one
JSON line per sweep. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BLOCK, BATCH, D_C, D_R = 128, 4, 512, 64
SHAPES = ((640, 528), (32768, 32768))        # (capacity, tokens per row)
HEADS, EXTRA_HEADS = 32, (128,)              # mla-7b plans; deepseek-v3-mla recorded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "H100_splits_profile.json"))
    ap.add_argument("--iters", type=int, default=20, help="launches per CUDA graph")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("measure_split_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.mla_decode import autotune
    name, limit = [x.strip() for x in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].split(",")]
    profile = autotune.SplitProfile(device={"name": name, "power_limit": limit,
                                            "torch": torch.__version__,
                                            "cuda": torch.version.cuda})
    t0 = time.time()
    for capacity, tokens in SHAPES:
        for layout in ("contiguous", "paged"):
            for rescale in ("fma", "amla"):
                kw = dict(d_c=D_C, d_r=D_R, fill=tokens / capacity, iters=args.iters,
                          layout=layout, rescale=rescale, device="cuda")
                measured = autotune.measure_split_sweep(capacity, BLOCK, BATCH, heads=HEADS,
                                                        profile=profile, **kw)
                key = autotune._key(capacity, BLOCK, BATCH, layout, rescale)
                entry = profile.entries[key]
                entry["heads"] = HEADS
                line = dict(key=key, heads=HEADS, measured_us=measured, best=entry["best"])
                for heads in EXTRA_HEADS:
                    side = autotune.SplitProfile()
                    autotune.measure_split_sweep(capacity, BLOCK, BATCH, heads=heads,
                                                 profile=side, **kw)
                    entry.setdefault("by_heads", {})[str(heads)] = side.entries[key]
                    line[f"h{heads}"] = side.entries[key]
                print(json.dumps(line), flush=True)
    path = profile.save(args.out)
    print(json.dumps({"profile": str(path), "device": profile.device,
                      "entries": len(profile.entries), "seconds": time.time() - t0}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
