"""Run one cell of the benchmark once and print its result line:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its per-layer metrics are found
by name in BENCHMARK.json. The run needs the card; it never falls back to
the CPU."""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness import cell
    sys.exit(cell.main(sys.argv[1:], T_START))
