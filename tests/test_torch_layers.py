"""The port's transformer layers against the reference's ``models/layers.py``
on the same (numpy-seeded) weights and inputs: the MLP's activations
(``"gelu"`` is the tanh form, as ``jax.nn.gelu``'s default), ``project_qkv``
with and without QKV bias, ``sdpa`` and ``flash_sdpa`` with the causal and
sliding-window masks, and ``attention_block``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _mlp_params(seed, d, f, gated, identity=False):
    if identity:                       # the MLP is then act(x) (* x): the activation alone
        wg = wu = wd = np.eye(d, dtype=np.float32)
    else:
        wg, wu, wd = _rng_arrays(seed, (d, f), (d, f), (f, d), scale=0.3)
    j = JL.MLPParams(jnp.asarray(wg) if gated else None, jnp.asarray(wu), jnp.asarray(wd))
    t = TL.MLPParams(torch.from_numpy(wg) if gated else None, torch.from_numpy(wu),
                     torch.from_numpy(wd))
    return j, t


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "silu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_activation_matches_reference(act, gated):
    """Identity weights isolate the activation: ungated, the MLP is act(x),
    within 1e-6; gated, act(x) * x, within 1e-5 (near x = -5 the tanh form's
    1 + tanh is a few float32 ulps of 1, which the product with x magnifies).
    Random weights add the products, whose float32 summation order differs
    (within 1e-5)."""
    (x,) = _rng_arrays(2, (4, 7, 32), scale=3.0)          # |x| up to ~10: both tails
    for identity, tol in ((True, 1e-5 if gated else 1e-6), (False, 1e-5)):
        jp, tp = _mlp_params(1, 32, 64, gated, identity)
        want = np.asarray(jax.jit(lambda p, a: JL.mlp(p, a, act))(jp, jnp.asarray(x)))
        got = TL.mlp(tp, torch.from_numpy(x), act).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_gelu_is_the_tanh_form():
    """``"gelu"`` equals ``"gelu_tanh"`` in the port, and equals
    ``jax.nn.gelu`` (approximate=True) elementwise within 1e-6, where the
    exact erf form is up to ~4e-4 away at |x| = 3."""
    x = torch.linspace(-6.0, 6.0, 2401)
    ident = TL.MLPParams(None, torch.ones((1, 1)), torch.ones((1, 1)))
    gelu = TL.mlp(ident, x[:, None], "gelu")[:, 0]
    assert torch.equal(gelu, TL.mlp(ident, x[:, None], "gelu_tanh")[:, 0])
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(gelu.numpy(), want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(x)
    assert float((erf - gelu).abs().max()) > 1e-4


def _attn(seed, d, H, Hkv, dh, bias):
    wq, wk, wv, wo, bq, bk, bv = _rng_arrays(
        seed, (d, H, dh), (d, Hkv, dh), (d, Hkv, dh), (H, dh, d), (H, dh), (Hkv, dh),
        (Hkv, dh), scale=0.2)
    arrs = [wq, wk, wv, wo] + ([bq, bk, bv] if bias else [None] * 3)
    j = JL.AttnParams(*(None if a is None else jnp.asarray(a) for a in arrs))
    t = TL.AttnParams(*(None if a is None else torch.from_numpy(a) for a in arrs))
    return j, t


@pytest.mark.parametrize("bias,window", [(False, 0), (True, 0), (False, 5)])
def test_attention_block_matches_reference(bias, window):
    d, H, Hkv, dh, S = 32, 4, 2, 16, 11
    jp, tp = _attn(4, d, H, Hkv, dh, bias)
    kw = dict(d_model=d, n_heads=H, n_kv_heads=Hkv, d_head=dh, rope_theta=500000.0,
              qkv_bias=bias, window=window)
    jcfg, tcfg = JL.AttnConfig(**kw), TL.AttnConfig(**kw)
    (x,) = _rng_arrays(5, (2, S, d))
    pos = np.arange(S)
    jq = jax.jit(lambda p, a: JL.project_qkv(p, jcfg, a, jnp.asarray(pos)))(jp, jnp.asarray(x))
    tq = TL.project_qkv(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    for use_flash in (True, False):
        want = jax.jit(lambda p, a: JL.attention_block(p, jcfg, a, jnp.asarray(pos),
                                                       use_flash=use_flash))(jp, jnp.asarray(x))
        got = TL.attention_block(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                 use_flash=use_flash)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset,block_k", [
    (True, 0, 0, 512), (True, 7, 0, 8), (False, 0, 0, 8), (True, 0, 5, 8), (True, 12, 3, 8)])
def test_sdpa_and_flash_match_reference(causal, window, q_offset, block_k):
    B, Sq, Sk, H, Hkv, dh = 2, 9, 21, 6, 2, 16
    q, k, v = _rng_arrays(6, (B, Sq, H, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh))
    if causal:
        Sk = Sq + q_offset
        k, v = k[:, :Sk], v[:, :Sk]
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax.jit(lambda *a: JL.sdpa(*a, **kw))(*jargs)
    np.testing.assert_allclose(TL.sdpa(*targs, **kw).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want = jax.jit(lambda *a: JL.flash_sdpa(*a, block_k=block_k, **kw))(*jargs)
    np.testing.assert_allclose(TL.flash_sdpa(*targs, block_k=block_k, **kw).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
