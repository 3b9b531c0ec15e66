"""Port quantization (repro_torch.core.quant) against the JAX reference: the
same numpy inputs through both, outputs compared bit for bit.

The JAX side runs under ``jax.jit``: XLA compiles ``x / qmax`` (a constant)
into ``x * f32(1 / qmax)``, which is what every jitted JAX path and every
Pallas kernel computes — and what the port implements. (Eager JAX divides
exactly and differs from its own compiled form by one ulp in many of the
scales.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq

FMTS = ["fp8_e4m3", "int8"]


def bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX/numpy array, fp8 and bf16 included."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def assert_same(t, j):
    tb, jb = bits(t), bits(j)
    assert tb.shape == jb.shape, (tb.shape, jb.shape)
    assert tb.dtype.itemsize == jb.dtype.itemsize
    np.testing.assert_array_equal(tb.view(jb.dtype) if tb.dtype != jb.dtype else tb, jb)


def _x(seed, shape, scale=3.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", ["quantize_per_token", "quantize_per_channel",
                                  "quantize_per_tensor"])
def test_granularity_bit_exact(name, fmt):
    x = _x(1, (6, 40, 96))
    x[0, 0] = 0.0                       # an all-zero row exercises the EPS floor
    jr = jax.jit(lambda a: getattr(jq, name)(a, fmt))(x)
    tr = getattr(tq, name)(torch.from_numpy(x), fmt)
    assert_same(tr.q, jr.q)
    assert_same(tr.scale, jr.scale)


@pytest.mark.parametrize("fmt", FMTS)
def test_per_block_and_static_tensor_bit_exact(fmt):
    x = _x(2, (2, 128, 192))
    jr = jax.jit(lambda a: jq.quantize_per_block(a, (64, 64), fmt))(x)
    tr = tq.quantize_per_block(torch.from_numpy(x), (64, 64), fmt)
    assert_same(tr.q, jr.q)
    assert_same(tr.scale, jr.scale)
    js = jax.jit(lambda a: jq.quantize_per_tensor(a, fmt, static_scale=1.0))(x)
    ts = tq.quantize_per_tensor(torch.from_numpy(x), fmt, static_scale=1.0)
    assert_same(ts.q, js.q)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("rope_dtype", ["bfloat16", "float32"])
def test_rope_aware_bit_exact(fmt, rope_dtype):
    c, r = _x(3, (4, 24, 64)), _x(4, (4, 24, 16), 25.0)
    jr = jax.jit(lambda a, b: jq.quantize_rope_aware(
        a, b, fmt, rope_dtype=getattr(jnp, rope_dtype)))(c, r)
    tr = tq.quantize_rope_aware(torch.from_numpy(c), torch.from_numpy(r), fmt,
                                rope_dtype=getattr(torch, rope_dtype))
    assert_same(tr.q_content, jr.q_content)
    assert_same(tr.rope_scaled, jr.rope_scaled)
    assert_same(tr.scale, jr.scale)
    ju = jax.jit(lambda a, b: jq.quantize_rope_unaware(a, b, fmt))(c, r)
    tu = tq.quantize_rope_unaware(torch.from_numpy(c), torch.from_numpy(r), fmt)
    assert_same(tu.q_content, ju.q_content)
    assert_same(tu.rope_scaled, ju.rope_scaled)
    assert_same(tu.scale, ju.scale)


@pytest.mark.parametrize("fmt", FMTS)
def test_fuse_and_quantize_p_bit_exact(fmt):
    rs = np.random.RandomState(5)
    p = rs.rand(8, 4, 128).astype(np.float32)
    vs = (rs.rand(8, 1, 128) * 0.02 + 1e-4).astype(np.float32)
    jp, jsp = jax.jit(lambda a, b: jq.fuse_and_quantize_p(a, b, fmt))(p, vs)
    tp, tsp = tq.fuse_and_quantize_p(torch.from_numpy(p), torch.from_numpy(vs), fmt)
    assert_same(tp, jp)
    assert_same(tsp, jsp)


@pytest.mark.parametrize("granularity", ["per_token", "per_channel", "per_tensor",
                                         "per_block"])
def test_quant_mse_and_range(granularity):
    x = _x(6, (128, 128))
    jm = jax.jit(lambda a: jq.quant_mse(a, "fp8_e4m3", granularity))(x)
    tm = tq.quant_mse(torch.from_numpy(x), "fp8_e4m3", granularity)
    # the round trip is bit-exact; only the mean's summation order differs
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    lo, hi = tq.dynamic_range(torch.from_numpy(x))
    jlo, jhi = jq.dynamic_range(x)
    assert float(lo) == float(jlo) and float(hi) == float(jhi)


def test_casts_and_helpers_match():
    assert tq.qmax_for("fp8_e4m3") == jq.qmax_for("fp8_e4m3") == 448.0
    assert tq.qmax_for("int8") == jq.qmax_for("int8") == 127.0
    assert tq.EPS == jq.EPS
    with pytest.raises(ValueError):
        tq.qmax_for("none")
    # round-half-to-even and the ±448 clip, on values that sit on the ties
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 500.0, -1e4, 3.3e-3,
                  1.0625, 1.1875, 449.0], np.float32)
    for fmt in FMTS:
        assert_same(tq._cast(torch.from_numpy(x), fmt),
                    jax.jit(lambda a: jq._cast(a, fmt))(x))
