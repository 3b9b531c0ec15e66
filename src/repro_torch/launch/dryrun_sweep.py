"""The dry-run sweep (port of ``repro/launch/dryrun_sweep.py``): every
(architecture x shape x mesh) cell.

Each cell runs in a fresh subprocess (``python -m
repro_torch.launch.dryrun``, ``PYTHONPATH=src``: each builds its own fake
world of 256 or 512 ranks, and cells run in parallel); results land as JSON
in --out-dir and are aggregated into sweep.json.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_sweep \\
        --out-dir results/dryrun --jobs 4 [--mesh pod multipod]

Wave 1 runs every cell with ``--no-cost-pass``; wave 2 reruns the
single-pod cells with the FLOP pass. A cell whose JSON already holds a
finished result (for wave 2, one with the FLOP pass) is not run again.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS_DEFAULT = [
    "llama-3.2-vision-90b", "llama3.2-3b", "gemma3-27b", "qwen2.5-3b",
    "granite-3-2b", "qwen3-moe-30b-a3b", "mixtral-8x7b", "recurrentgemma-9b",
    "whisper-base", "xlstm-1.3b", "deepseek-v3-mla", "mla-7b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run_one(arch, shape, mesh, out_dir, timeout, cost=False):
    out = pathlib.Path(out_dir) / f"{arch}__{shape}__{mesh}.json"
    if out.exists():
        try:
            r = json.loads(out.read_text())
            done = r.get("status") in ("ok", "skipped")
            if done and cost and r.get("status") == "ok":
                done = bool(r.get("cost_pass", {}).get("exact"))
            if done:
                return arch, shape, mesh, r.get("status"), "cached"
        except json.JSONDecodeError:
            pass
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out)]
    if not cost:
        cmd.append("--no-cost-pass")
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                           env={**os.environ, "PYTHONPATH": "src"})
        if p.returncode != 0:
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "stderr": p.stderr[-3000:]}))
            last = p.stderr.strip().splitlines()[-1][:120] if p.stderr.strip() else "?"
            return arch, shape, mesh, "error", last
        return arch, shape, mesh, "ok", f"{time.time() - t0:.0f}s"
    except subprocess.TimeoutExpired:
        out.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh,
                                   "status": "timeout"}))
        return arch, shape, mesh, "timeout", f">{timeout}s"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--mesh", nargs="+", default=["pod", "multipod"])
    ap.add_argument("--archs", nargs="+", default=ARCHS_DEFAULT)
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = [(a, s, m) for a in args.archs for s in args.shapes for m in args.mesh]

    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        # wave 1: every cell's sharded step (the dry-run deliverable)
        futs = [ex.submit(run_one, a, s, m, out_dir, args.timeout, False)
                for a, s, m in cells]
        for f in futs:
            a, s, m, st, msg = f.result()
            print(f"wave1 {a:24s} {s:12s} {m:8s} {st:8s} {msg}", flush=True)
        # wave 2: the global FLOP pass, single-pod cells only
        futs = [ex.submit(run_one, a, s, m, out_dir, args.timeout, True)
                for a, s, m in cells if m == "pod"]
        for f in futs:
            a, s, m, st, msg = f.result()
            print(f"wave2 {a:24s} {s:12s} {m:8s} {st:8s} {msg}", flush=True)

    agg = []
    for p in sorted(out_dir.glob("*.json")):
        if p.name == "sweep.json":
            continue
        try:
            agg.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            pass
    (out_dir / "sweep.json").write_text(json.dumps(agg, indent=1))
    n_ok = sum(1 for r in agg if r.get("status") == "ok")
    n_skip = sum(1 for r in agg if r.get("status") == "skipped")
    n_bad = len(agg) - n_ok - n_skip
    print(f"\nsweep: {n_ok} ok, {n_skip} skipped, {n_bad} failed "
          f"-> {out_dir / 'sweep.json'}")
    return 0 if n_bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
