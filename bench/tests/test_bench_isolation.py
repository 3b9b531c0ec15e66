"""The harness loads neither JAX nor the JAX package, and refuses to run
without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_harness_imports_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from harness import cell, offline_decode, check, model, trace, traffic\n"
            "from plainref import mla_fp8\n"
            "import repro_torch.launch.steps, repro_torch.models.transformer\n"
            "cell.readers(cell.load_benchmark(), 'dsv3.decode_32k')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}))" % (str(BENCH), str(BENCH / "metrics")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_fails_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "dsv3.decode_32k", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=_env(), timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result without a card: {line}")
