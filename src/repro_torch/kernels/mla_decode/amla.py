"""AMLA power-of-two rescaling helpers (port of
``repro/kernels/mla_decode/amla.py``).

With the running max and the P scale on the power-of-two grid (``m = i*ln2``,
``sigma_p = 2^e``), every cross-block rescale is an exact ``2^k``, applied by
adding ``k << 23`` to the float32 bit pattern (``exp2_mul``). These helpers
are the plain versions of the device functions of the same names in
``repro_torch/csrc/common.cuh``, which the CUDA kernels use; the decode refs
(``ref.py``) use them for ``rescale="amla"``.

The arithmetic is the reference's as it runs compiled, and the tests hold it
bit for bit against jitted JAX on edge values:

  * ``log2(x)`` is ``log(x) * f32(1/ln2)`` (``jnp.log2`` is ``log(x)/log(2)``,
    and XLA multiplies by the reciprocal of the constant);
  * the ``exp2_mul`` fallback flushes subnormal inputs and results to signed
    zero, as XLA's compiled CPU code (and the TPU) does;
  * the power ``2^-e`` that scales P is exact here, where XLA's ``exp2`` of an
    integer can be an ulp off the power of two; the fp8 codes differ only if
    a product lands within an ulp of an fp8 rounding boundary.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant

LN2 = 0.6931471805599453
LOG2E = 1.4426950408889634
# the float32 constants the reference's compiled arithmetic uses; f32(1/ln2)
# equals f32(log2 e)
LN2_F32 = float.fromhex("0x1.62e43p-1")
LOG2E_F32 = float.fromhex("0x1.715476p+0")
TINY = torch.finfo(torch.float32).tiny


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < TINY, torch.copysign(torch.zeros_like(x), x), x)


def pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` for integer ``k``, exactly; 0 below 2^-126 and +inf above
    2^127 (the reference's ``exp2`` at the ends of the float32 range)."""
    k = k.to(torch.int32)
    p = ((torch.clamp(k, -126, 127) + 127) << 23).view(torch.float32)
    p = torch.where(k < -126, 0.0, p)
    return torch.where(k > 127, float("inf"), p)


def exp2_mul(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x * 2**k`` for float32 ``x`` and integer ``k`` (broadcast): an integer
    add on the exponent field where input and result are normal numbers,
    else the flushed multiply by ``2^k`` (zeros, subnormals, exponent
    overflow and underflow)."""
    x = x.float()
    k = k.to(torch.int32)
    bits = x.view(torch.int32)
    biased = (bits >> 23) & 0xFF
    shifted = biased + k
    fast = (biased > 0) & (shifted > 0) & (shifted < 255)
    y = (bits + (k << 23)).view(torch.float32)
    slow = _flush_subnormal(_flush_subnormal(x) * pow2(k))
    return torch.where(fast, y, slow)


def quantize_block_pow2(p_fused: torch.Tensor, fmt: str, qmax: float):
    """Block-wise dynamic P quantization with a power-of-two scale
    ``sigma_p = 2^e`` (rounded up, so ``|p| / sigma_p <= qmax``). Returns
    ``(p8 as float32, e)`` with the exponent ``e`` as a float of integers;
    ``"none"`` keeps P unquantized with ``e = 0``."""
    amax = torch.amax(torch.abs(p_fused), dim=-1)
    if fmt == "none":
        return p_fused, torch.zeros_like(amax)
    e = torch.ceil(torch.log(quant.dynamic_scale(amax, qmax)) * LOG2E_F32)
    inv = pow2(-e.to(torch.int32))
    return quant._cast(p_fused * inv[..., None], fmt).float(), e
