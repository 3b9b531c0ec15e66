"""What every cell's run shares: the cache directories, the device checks,
derived seeds, the check for JAX in the process, and the result line."""
from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(RuntimeError):
    """A run that cannot produce a result (no card, a bad cell)."""


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def src_on_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def require_cards(chips: int):
    """The CUDA device, or CellError: a run never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise CellError("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def emit(result: dict, compared: list[tuple[str, float, float]]) -> None:
    """Each compared number beside its limit, last on standard error, then the
    result line (compared numbers under ``compared``, its last key) last on
    standard output."""
    for name, value, limit in compared:
        print(f"compared {name} = {value!r} limit {limit!r}", file=sys.stderr)
    result = dict(result)
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in compared}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
