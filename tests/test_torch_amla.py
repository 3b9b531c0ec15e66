"""AMLA (power-of-two rescale) in the port against the JAX package: the
helpers bit for bit on edge values against jitted JAX, the AMLA decode
oracles and the AMLA combine against the JAX oracles and Pallas kernels
(interpret mode) on the SAME quantized bytes, to the reference's own
tolerances (tests/test_parity.py:148-221: o atol 1e-4, lse atol 1e-5;
AMLA vs FMA within 5% under fp8 and 1e-5 unquantized)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mla_decode import amla as JA
from repro.kernels.mla_decode import ref as JR
from repro.kernels.mla_decode.kernel import (amla_combine_pallas, mla_decode_paged_pallas,
                                             mla_decode_paged_splitkv_pallas)
from repro_torch.core import quant as TQ
from repro_torch.kernels.mla_decode import amla as TA
from repro_torch.kernels.mla_decode import kernel as TK
from repro_torch.kernels.mla_decode import ref as TR

from test_torch_mla_decode import SCALE, _setup

O_TOL, LSE_TOL = dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-5)


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)
    return np.where(np.isnan(a), np.int32(0x7FC00000), a.view(np.int32))


def test_constants_are_the_compiled_float32_ones():
    assert TA.LN2 == JA.LN2 and TA.LOG2E == JA.LOG2E
    assert TA.LN2_F32 == float(np.float32(JA.LN2))
    assert TA.LOG2E_F32 == float(np.float32(1) / np.log(np.float32(2)))


def test_exp2_mul_bit_exact_on_edge_values():
    """Zeros, subnormals, the smallest normal, huge and tiny normals, inf and
    NaN, against shifts that stay normal, underflow, overflow and leave the
    exponent range: the fast path, the flushed fallback and the ends of 2^k."""
    xs = np.array([0.0, -0.0, 1e-45, -3e-39, 1.1754944e-38, -1.1754944e-38, 1.0, -1.5,
                   3e38, -3.4e38, 2.0 ** -120, 7.0, 1e-30, 0.75, np.inf, -np.inf, np.nan],
                  np.float32)
    ks = np.array([-300, -200, -150, -149, -130, -127, -126, -125, -64, -30, -15, -1, 0,
                   1, 13, 15, 30, 64, 126, 127, 128, 200, 300], np.int32)
    X, K = (a.ravel() for a in np.meshgrid(xs, ks))
    want = jax.jit(JA.exp2_mul)(X, K)
    got = TA.exp2_mul(torch.from_numpy(X.copy()), torch.from_numpy(K.copy()))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_exp2_mul_random_matches_multiplication():
    rs = np.random.RandomState(0)
    x = (rs.standard_normal(5000) * 10.0 ** rs.uniform(-30, 30, 5000)).astype(np.float32)
    k = rs.randint(-40, 40, 5000).astype(np.int32)
    got = TA.exp2_mul(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(_bits(got), _bits(jax.jit(JA.exp2_mul)(x, k)))
    with np.errstate(over="ignore"):
        exact = (x.astype(np.float64) * 2.0 ** k).astype(np.float32)
    flushed = np.where(np.abs(exact) < np.finfo(np.float32).tiny, np.copysign(0.0, exact), exact)
    np.testing.assert_array_equal(_bits(got), _bits(flushed))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_quantize_block_pow2_bit_exact_on_edge_values(fmt):
    """Rows whose max is an exact power of two times qmax (where ceil(log2)
    turns on the last ulp of the log), all-zero rows and rows below the EPS
    floor, and random rows: the exponent e equals JAX's everywhere. P8 is
    the exact cast of p * 2^-e; JAX scales by its exp2(-e), which XLA
    computes a few ulp off the power of two, so its codes may differ from
    the port's only where p * 2^-e is an exact rounding tie (int8 rows whose
    max is 2^j * 127 land on 63.5)."""
    qmax = {"fp8_e4m3": 448.0, "int8": 127.0, "none": 1.0}[fmt]
    rs = np.random.RandomState(1)
    rows = []
    for j in range(-60, 12):
        r = rs.uniform(-1, 1, 16).astype(np.float32) * np.float32(2.0 ** j * qmax)
        r[3] = np.float32(2.0 ** j * qmax)
        rows.append(r)
    rows += [np.zeros(16, np.float32), np.full(16, 1e-14, np.float32),
             np.full(16, 1e-12, np.float32)]
    rows += list(rs.standard_normal((20, 16)).astype(np.float32)
                 * 10.0 ** rs.uniform(-6, 1, (20, 1)).astype(np.float32))
    p = np.stack(rows).astype(np.float32)
    p8_j, e_j = jax.jit(JA.quantize_block_pow2, static_argnums=(1, 2))(p, fmt, qmax)
    p8_t, e_t = TA.quantize_block_pow2(torch.from_numpy(p), fmt, qmax)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    if fmt == "none":
        np.testing.assert_array_equal(_bits(p8_t), _bits(p8_j))
        return
    exact = p.astype(np.float64) * 2.0 ** -e_t.numpy()[:, None]     # exact scaling

    def cast(x):
        return TQ._cast(torch.from_numpy(x.astype(np.float32)), fmt).float().numpy()

    np.testing.assert_array_equal(p8_t.numpy(), cast(exact))
    diff = p8_t.numpy() != np.asarray(p8_j)
    ties = cast(exact * (1 - 1e-6)) != cast(exact * (1 + 1e-6))
    assert not (diff & ~ties).any()
    assert diff.sum() <= (2 if fmt == "int8" else 0)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_paged_amla_matches_pallas_and_ref(fmt, num_splits):
    j_ops, t_ops, _ = _setup(fmt, seed=7)
    j_ops = j_ops[:4] + (j_ops[4].astype(jnp.float32),) + j_ops[5:]
    kw = dict(softmax_scale=SCALE, num_splits=num_splits, fmt=fmt, rescale="amla")
    o_k, lse_k, (acc_k, l_k, g_k) = mla_decode_paged_splitkv_pallas(
        *j_ops, return_partials=True, **kw)
    o_r, lse_r = JR.snapmla_decode_paged_splitkv_ref(*j_ops, **kw)
    o_t, lse_t, (acc_t, l_t, g_t) = TK.mla_decode_paged_splitkv_cuda(
        *t_ops, return_partials=True, **kw)
    for o, lse in ((o_k, lse_k), (o_r, lse_r)):
        # the row with seq_len 0 is all-empty: (NaN, -inf) everywhere
        np.testing.assert_allclose(o_t.numpy()[1:], np.asarray(o)[1:], **O_TOL)
        np.testing.assert_allclose(lse_t.numpy()[1:], np.asarray(lse)[1:], **LSE_TOL)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_k))     # integer grid
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_k), rtol=1e-5, atol=0)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_k), rtol=1e-5, atol=1e-4)
    assert np.isnan(o_t.numpy()[0]).all() and np.isneginf(lse_t.numpy()[0]).all()


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "none"])
def test_paged_single_pass_amla_matches_pallas(fmt):
    j_ops, t_ops, _ = _setup(fmt, seed=8)
    kw = dict(softmax_scale=SCALE, fmt=fmt, rescale="amla")
    o_k, lse_k = mla_decode_paged_pallas(*j_ops, **kw)
    o_t, lse_t = TK.mla_decode_paged_cuda(*t_ops, **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_k), equal_nan=True, **O_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_k), equal_nan=True, **LSE_TOL)


def test_amla_combine_matches_pallas_and_ref():
    rs = np.random.RandomState(3)
    acc = rs.standard_normal((3, 4, 4, 32)).astype(np.float32) * 50
    l = rs.uniform(1, 300, (3, 4, 4)).astype(np.float32)
    g = rs.randint(-40, 20, (3, 4, 4)).astype(np.float32)
    acc[0, 1:], l[0, 1:], g[0, 1:] = 0.0, 0.0, 0.0     # empty splits
    acc[1, 2], l[1, 2], g[1, 2] = 0.0, 0.0, 0.0
    o_k, lse_k = amla_combine_pallas(jnp.asarray(acc), jnp.asarray(l), jnp.asarray(g))
    o_r, lse_r = JR.amla_combine_ref(acc, l, g)
    o_t, lse_t = TK.amla_combine_cuda(*(torch.from_numpy(x) for x in (acc, l, g)))
    for o, lse in ((o_k, lse_k), (o_r, lse_r)):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_amla_vs_fma_in_the_port(num_splits):
    """The reference's own AMLA-vs-FMA bounds, on the port's kernels' plain
    versions: 5% of the largest |o| and lse within 1e-5 under fp8."""
    _, t_ops, _ = _setup("fp8_e4m3", lens=[20, 128, 65, 99], seed=9)
    kw = dict(softmax_scale=SCALE, num_splits=num_splits)
    o_f, lse_f = TK.mla_decode_paged_splitkv_cuda(*t_ops, rescale="fma", **kw)
    o_a, lse_a = TK.mla_decode_paged_splitkv_cuda(*t_ops, rescale="amla", **kw)
    assert float((o_a - o_f).abs().max() / o_f.abs().max()) < 0.05
    torch.testing.assert_close(lse_a, lse_f, rtol=1e-5, atol=1e-5)


def test_amla_unquantized_equals_fma():
    _, t_ops, _ = _setup("none", lens=[20, 128, 65, 99], seed=10)
    kw = dict(softmax_scale=SCALE, num_splits=2, fmt="none")
    o_f, _ = TK.mla_decode_paged_splitkv_cuda(*t_ops, rescale="fma", **kw)
    o_a, _ = TK.mla_decode_paged_splitkv_cuda(*t_ops, rescale="amla", **kw)
    torch.testing.assert_close(o_a, o_f, rtol=1e-5, atol=1e-5)


def test_rescale_is_checked():
    _, t_ops, _ = _setup("fp8_e4m3", lens=[5, 9], seed=11)
    with pytest.raises(ValueError, match="rescale"):
        TR.snapmla_decode_paged_ref(*t_ops, softmax_scale=SCALE, rescale="fast")


def _one_split_partials():
    """Raw AMLA partials of one split (S = 1) on the edges where #4 is not
    acc / l: -0 and subnormal acc entries, a subnormal l, and a row with no
    token (acc = l = g = 0)."""
    acc = np.array([[[[1.5, -0.0, 1e-40, -3e-39, 2.0 ** -126, -7.25, 0.0, 3e38],
                      [0.5, -2.0, -0.0, 1e-44, 4.0, 1e-30, -1e-39, 2.5],
                      [0.0] * 8]]], np.float32)                     # [B=1, S=1, H=3, 8]
    l = np.array([[[3.75, 1e-40, 0.0]]], np.float32)
    g = np.array([[[-7.0, 12.0, 0.0]]], np.float32)
    return acc, l, g


def test_amla_combine_at_one_split_pins_the_folded_bits():
    """#4 on one split (what the folded AMLA split kernel computes on its
    registers at S = 1): the sums start from +0 and exp2_mul(x, 0) flushes a
    subnormal x, so o = (+0 + flush(acc)) / (+0 + flush(l)) — not acc / l on
    -0 and subnormal entries — and lse = K* ln2 + log(den), K* = g where
    l > 0 else -1e30 (a row with no token: NaN and -inf). The plain version
    gives exactly these bits, and agrees with JAX's combine (oracle and
    Pallas kernel, interpret mode) where both are finite."""
    acc, l, g = _one_split_partials()
    o_t, lse_t = TK.amla_combine_cuda(*(torch.from_numpy(x) for x in (acc, l, g)))
    zero = torch.zeros((), dtype=torch.float32)
    k0 = torch.zeros((), dtype=torch.int32)
    den = zero + TA.exp2_mul(torch.from_numpy(l[:, 0]), k0)
    o_want = (zero + TA.exp2_mul(torch.from_numpy(acc[:, 0]), k0)) / den[..., None]
    k_star = torch.where(torch.from_numpy(l[:, 0]) > 0, torch.from_numpy(g[:, 0]),
                         torch.tensor(TR.NEG_INF))
    lse_want = k_star * TA.LN2_F32 + torch.log(den)
    np.testing.assert_array_equal(_bits(o_t), _bits(o_want))
    np.testing.assert_array_equal(_bits(lse_t), _bits(lse_want))
    # the edges: +0 for -0 and for subnormals, NaN / -inf for the empty row
    assert _bits(o_t)[0, 0, 1] == 0 and _bits(o_t)[0, 0, 2] == 0 and _bits(o_t)[0, 0, 3] == 0
    naive = acc[0, 0, 0] / l[0, 0, 0]
    assert (_bits(o_t)[0, 0] != _bits(naive)).sum() == 3     # not acc / l there
    assert np.isnan(o_t[0, 2].numpy()).all() and lse_t[0, 2] == -np.inf
    assert np.isinf(o_t[0, 1].numpy()).sum() + np.isnan(o_t[0, 1].numpy()).sum() == 8
    for o_j, lse_j in (JR.amla_combine_ref(acc, l, g),
                       amla_combine_pallas(jnp.asarray(acc), jnp.asarray(l), jnp.asarray(g))):
        np.testing.assert_allclose(o_t[0, 0].numpy(), np.asarray(o_j)[0, 0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(lse_t[0, ::2].numpy(), np.asarray(lse_j)[0, ::2], rtol=1e-6)
        assert np.isnan(np.asarray(o_j)[0, 2]).all()
