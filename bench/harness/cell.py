"""One run of one cell: find the cell, its configuration and traffic files
and its metric readers by the names in BENCHMARK.json, run the cell's driver
and print the result."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys

from harness import common

DRIVERS = ("offline_decode",)


def load_benchmark() -> dict:
    return json.loads((common.ROOT / "BENCHMARK.json").read_text())


def find(bench: dict, workload: str):
    """(cell entry, configuration file, traffic file) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise common.CellError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf_data = json.loads((common.ROOT / conf["file"]).read_text())
    traffic = json.loads((common.BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    return cell, conf_data, traffic


def readers(bench: dict, workload: str) -> dict:
    """name -> (unit, read) of the per-layer metrics this cell reports: those
    that list it, and those without a list whose end-to-end metric it
    reports."""
    mine = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    metrics_dir = common.BENCH / "metrics"
    if str(metrics_dir) not in sys.path:
        sys.path.insert(0, str(metrics_dir))
    out = {}
    for m in bench["per_layer"]:
        if workload in m.get("workloads", [workload] if m["moves"] in mine else []):
            path = metrics_dir / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(
                "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[m["name"]] = (m["unit"], mod.read)
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    common.src_on_path()
    try:
        bench = load_benchmark()
        cell, conf, wl = find(bench, args.workload)
        device = common.require_cards(cell["chips"])
    except (common.CellError, OSError, KeyError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    if wl["driver"] not in DRIVERS:
        print(f"bench: unknown driver {wl['driver']!r}", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"harness.{wl['driver']}")
    out = driver.run(conf, wl, args.seed, args.seconds, bool(args.trace), device,
                     t_start=t_start, readers=readers(bench, args.workload) if args.trace else {})
    found = common.forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}: the benchmark may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    device_info = common.device_info(device, cell["chips"], out.peak)
    device_info.update(out.device_extra)
    result = {"correct": bool(out.correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": out.metrics, "device": device_info}
    if out.breakdown is not None:
        result["breakdown"] = out.breakdown
    common.emit(result, out.compared)
    return 0
