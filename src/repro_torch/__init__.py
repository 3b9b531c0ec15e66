"""PyTorch + CUDA port of the SnapMLA serving path (the JAX package ``repro``
stays the reference).

The port imports ``torch`` and never ``jax`` or ``repro``. Its entry points
run on ``cuda`` unless the caller asks for ``cpu``; a ``cuda`` request on a
machine without a card raises instead of falling back. The hand-written
Hopper kernels live under ``csrc/`` and are built on first use
(``kernels/_lib.py``); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Float32 matrix products run in full float32, as the JAX reference computes
them: TF32 is switched off for both matmuls and cuDNN here, where the port
starts.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Raises when ``cuda`` is requested and there is no card — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' (or --device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev
