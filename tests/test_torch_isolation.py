"""The port imports neither JAX nor the JAX package: every ``repro_torch``
module imports in a fresh interpreter where ``import jax`` fails, leaves no
``repro.`` module loaded, and no source line imports either."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert sys.modules["jax"] is None
print(" ".join(names))
"""

# modules the isolation checks must reach (the later slices' among them)
_REQUIRED = ("repro_torch.serving.tiering", "repro_torch.checkpoint.checkpoint",
             "repro_torch.runtime.fault_tolerance", "repro_torch.obs.trace",
             "repro_torch.obs.trace_report", "repro_torch.obs.quant_health",
             "repro_torch.kernels.mla_decode.autotune", "repro_torch.models.rglru",
             "repro_torch.models.xlstm", "repro_torch.configs.recurrentgemma_9b",
             "repro_torch.configs.xlstm_1_3b", "repro_torch.configs.whisper_base",
             "repro_torch.configs.llama32_vision_90b", "repro_torch.optim.adamw",
             "repro_torch.optim.schedule", "repro_torch.optim.grad_compression",
             "repro_torch.data.pipeline", "repro_torch.runtime.straggler",
             "repro_torch.launch.train", "repro_torch.core.distributed_decode",
             "repro_torch.launch.mesh", "repro_torch.launch.sharding")


def test_import_every_module_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20                   # every module of the slice was imported
    assert set(_REQUIRED) <= set(names), set(_REQUIRED) - set(names)


def test_no_jax_or_repro_import_in_sources():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    rel = {str(f.relative_to(ROOT / "src")).replace("/", ".")[:-3] for f in files[:-1]}
    assert set(_REQUIRED) <= rel
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
