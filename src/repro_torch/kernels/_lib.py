"""Build and load the port's hand-written Hopper kernels.

The CUDA C++ sources under ``repro_torch/csrc/`` have a plain C interface.
At first use each source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into one shared library under
``<repo>/build/``, and the library is loaded with ``ctypes``. The library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a built one is reused. No ``--use_fast_math``: the kernels use
``expf``/``logf`` and true division so they agree bit for bit with their
plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a wrapper
adds one where it launches its kernel and nowhere else (CPU calls that take
the plain version do not count). A launch made while the current stream is
being captured into a CUDA graph runs only when the graph is replayed, so it
counts in ``CAPTURED`` instead: the kernels of a graph launch ``CAPTURED``
times its replays.

``HeadTiles`` is the head-tile rule the decode wrappers share: of the widths
a kernel is instantiated for, the widest whose grid covers the card's SMs.
The fetch-dequant wrapper picks its tokens per warp by the same rule.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("mla_decode.cu", "mla_decode_sm90.cu", "q_quant.cu", "k_append.cu",
           "fetch_dequant.cu", "gqa_decode.cu")
HEADERS = ("common.cuh", "mla_merge.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
LAUNCHES: collections.Counter = collections.Counter()
# kernel name -> launches recorded into CUDA graphs since the last reset
CAPTURED: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # fmt, single_pass, amla, q_c8, q_r, sigma_q, q_lat, q_rope, content, rope,
    # scale, page_table, seq_lens, sink, S_k, o_part, lse_part, sp_part, o,
    # lse, tickets, B, H, d_c, d_r, block, P, num_splits, blocks_per_split,
    # softmax_scale, q_len, width, stream
    "snapmla_decode": [_I] * 3 + [_P] * 11 + [_I] + [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P],
    # q_c8, q_r, sigma_q, q_lat, q_rope, content, rope, scale, page_table,
    # seq_lens, o_part, lse_part, o, lse, tickets, B, H, n_pages, page, P,
    # num_splits, pages_per_split, softmax_scale, stream
    "snapmla_decode_sm90": [_P] * 15 + [_I] * 7 + [_F, _P],
    # o_part, lse_part, o, lse, B, S, H, d_c, stream
    "snapmla_lse_combine": [_P] * 4 + [_I] * 4 + [_P],
    # acc_part, l_part, g_part, o, lse, B, S, H, d_c, stream
    "snapmla_amla_combine": [_P] * 5 + [_I] * 4 + [_P],
    # fmt, q, q_c8, q_r, sigma_q, B, H, d_c, d_r, full, stream
    "snapmla_fused_q_quant": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    # fmt, c_kv, k_r, content, rope, scale, seq_lens, B, N, d_c, d_r, full, stream
    "snapmla_fused_k_append": [_I] + [_P] * 6 + [_I] * 5 + [_P],
    # fmt, content, rope, scale, page_table, chunk_start, out, B, P, page, d_c,
    # d_r, tokens per warp, stream
    "snapmla_fetch_dequant": [_I] + [_P] * 6 + [_I] * 6 + [_P],
    # fmt, q, k, v, k_scale, v_scale, slot_pos, positions, o, B, N, Hkv, g, dh,
    # block, window, sm_scale, width, stream
    "snapmla_gqa_decode": [_I] + [_P] * 8 + [_I] * 7 + [_F, _I, _P],
}

_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None   # wall time of this process's build (None: reused)
BUILD_LOG: str = ""                  # nvcc's messages (ptxas -v) of the library's build
VARIANT_LOGS: dict = {}              # defines -> nvcc's messages of a variant's build


def reset_launches() -> None:
    LAUNCHES.clear()
    CAPTURED.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("repro_torch: nvcc not found (needs the CUDA toolkit "
                           "to build the Hopper kernels)")
    return found


def _digest(extra: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False, defines: tuple[str, ...] = ()) -> Path:
    """Compile the sources (one nvcc each, in parallel) and link the shared
    library; returns its path. ``verbose`` adds ``-Xptxas -v``; ``defines``
    (``-D`` names) build a variant library, e.g. ``("SNAPMLA_NO_VERIFY",)``
    without the q_len > 1 decode instantiations. nvcc's report is written
    beside the library (``.log``) and read back when the library is reused,
    into ``BUILD_LOG`` (``VARIANT_LOGS[defines]`` for a variant)."""
    global BUILD_SECONDS
    extra = (("-Xptxas", "-v") if verbose else ()) + tuple(f"-D{d}" for d in defines)
    lib_path = BUILD_DIR / f"libsnapmla_{_digest(extra)}.so"
    log_path = lib_path.with_suffix(".log")

    def keep(log: str) -> None:
        global BUILD_LOG
        if defines:
            VARIANT_LOGS[defines] = log
        else:
            BUILD_LOG = log

    if lib_path.exists() and log_path.exists():
        keep(log_path.read_text())
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    tag = f"{os.getpid()}_{lib_path.stem}"
    objs = [BUILD_DIR / f"{Path(s).stem}_{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / s),
                               "-o", str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = []
    for s, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {s}\n{out}")
        if p.returncode != 0:
            for q in procs:
                q.wait()
            raise RuntimeError(f"repro_torch: nvcc failed on {s}:\n{out}")
    tmp = BUILD_DIR / f"{lib_path.stem}_{tag}.so.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                           str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"repro_torch: link failed:\n{link.stdout}{link.stderr}")
    log = "\n".join(logs)
    tmp_log = log_path.with_name(f"{tmp.name}.log")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)   # the report first: a library without one is rebuilt
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    keep(log)
    if not defines:
        BUILD_SECONDS = time.time() - t0
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its entry points."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = load(build(verbose))
    return _lib


@contextlib.contextmanager
def using(handle: ctypes.CDLL):
    """Launch through ``handle`` (a variant library from ``load``) inside the
    block, e.g. to compare a launch with the same launch built otherwise."""
    global _lib
    saved, _lib = _lib, handle
    try:
        yield handle
    finally:
        _lib = saved


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a non-zero
    ``cudaError_t`` and count the launch under ``kernel`` (in ``CAPTURED``
    when the stream is capturing a CUDA graph)."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"repro_torch: {fn_name} failed with cudaError_t {rc}")
    (CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES)[kernel] += 1


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class HeadTiles:
    """The head-tile widths one kernel is instantiated for (widest first),
    the rule that picks one per launch, and an override for comparisons.
    The width decides only which CUDA block computes a head."""

    def __init__(self, what: str, widths: tuple[int, ...]):
        self.what, self.widths = what, widths
        self.forced: int | None = None

    def pick(self, blocks, sms: int) -> int:
        """The widest width whose grid, ``blocks(width)`` CUDA blocks, covers
        the card's ``sms`` SMs, else the narrowest (the most blocks)."""
        for w in self.widths:
            if blocks(w) >= sms:
                return w
        return self.widths[-1]

    @contextlib.contextmanager
    def forcing(self, width: int):
        """Launch at ``width`` inside the block in place of the rule's pick
        (the launch takes ``forced or`` the pick)."""
        if width not in self.widths:
            raise ValueError(f"{self.what} width {width} is not one of {self.widths}")
        saved, self.forced = self.forced, width
        try:
            yield
        finally:
            self.forced = saved


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Wrapper-side validation before a pointer is handed to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
