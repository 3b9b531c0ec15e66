"""The readings that set a cell's limits, on the card: for each seed, one
run of the cell (a short window) and the numbers compared, for the program
and for the control, the plain reference computed one precision lower
(TF32 matrix products) in the program's place at the same positions,
judged by the cell's own limits (``control_correct``). The tool fails if
the control comes out correct on any seed.

    python3 bench/control.py --workload <name> --seconds 3 --seeds 1 2 3 ...

One process for every seed; one JSON line per seed. The benchmark's own runs
never run the control."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cell, check, common  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also run the control")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    common.src_on_path()
    bench = cell.load_benchmark()
    entry, conf, wl = cell.find(bench, args.workload)
    device = common.require_cards(entry["chips"])
    import importlib
    import torch
    driver = importlib.import_module(f"harness.{wl['driver']}")
    limits = wl["check"]["limits"]
    passed = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = driver.run(conf, wl, seed, args.seconds, False, device, t_start=t0,
                         readers={}, control=i < args.control_seeds)
        control_correct = None
        if out.control is not None:
            control_correct, compared = check.judge(out.control, limits)
            for name, value, limit in compared:
                print(f"seed {seed} control {name} = {value!r} limit {limit!r}",
                      file=sys.stderr)
            if control_correct:
                passed.append(seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": out.readings,
                          "control": out.control, "correct": out.correct,
                          "control_correct": control_correct,
                          "metrics": out.metrics, "seconds": time.perf_counter() - t0}),
              flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if passed:
        print(f"control: the control came out correct under {args.workload}'s limits on "
              f"seeds {passed}: the limits do not separate it", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
