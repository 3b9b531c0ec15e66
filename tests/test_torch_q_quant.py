"""Port Fused-Q-Quant against the JAX Pallas kernel (interpret mode), bit for
bit: sigma_q, the q_c8 bytes and q_r/sigma_q."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.kernel import fused_q_quant_pallas
from repro_torch.kernels.quantize import kernel as TK
from repro_torch.kernels.quantize import ops as tops
from repro_torch.kernels.quantize import ref as TR
from repro_torch.kernels.mla_decode import ref as TMR


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("B,H,d_c,d_r", [(1, 4, 32, 16), (3, 8, 64, 16), (2, 32, 512, 64)])
def test_fused_q_quant_ref_bit_exact_vs_pallas(fmt, B, H, d_c, d_r):
    rs = np.random.RandomState(B * 100 + H)
    q = (rs.standard_normal((B, H, d_c + d_r)) * 4).astype(np.float32)
    q[0, 0, :d_c] = 0.0                   # EPS floor row
    q[-1, -1, :4] = [448.0, -0.5, 2.5, 1e-3]
    jk = fused_q_quant_pallas(jnp.asarray(q), d_c, fmt=fmt)
    tr = TR.fused_q_quant_ref(torch.from_numpy(q), d_c, fmt=fmt)
    for t, j in zip(tr, jk):
        assert t.shape == tuple(np.asarray(j).shape)
        np.testing.assert_array_equal(_bits(t), _bits(j))
    # the wrapper on CPU tensors and the ops entry point are the same function
    for out in (TK.fused_q_quant_cuda(torch.from_numpy(q), d_c, fmt=fmt),
                tops.fused_q_quant(torch.from_numpy(q), d_c, fmt=fmt),
                tops.fused_q_quant(torch.from_numpy(q), d_c, fmt=fmt, use_kernel=False)):
        for t, r in zip(out, tr):
            np.testing.assert_array_equal(_bits(t), _bits(r))


def test_fused_q_quant_equals_prepare_q():
    """The model path's prepare_q and Fused-Q-Quant compute the same function
    (the port sends the query through the kernel where the reference calls
    prepare_q)."""
    q = (np.random.RandomState(0).standard_normal((2, 4, 48)) * 3).astype(np.float32)
    tq = torch.from_numpy(q)
    for fmt in ("fp8_e4m3", "int8"):
        for a, b in zip(TR.fused_q_quant_ref(tq, 32, fmt),
                        TMR.prepare_q(tq[..., :32], tq[..., 32:], fmt)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
