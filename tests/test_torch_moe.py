"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the same numpy-seeded weights and
inputs:

  * ``moe_layer`` within rtol / atol 1e-5 of the jitted JAX layer (as every
    JAX model path runs it), and the dropped fraction exactly equal, over
    token counts giving capacity C = 1 and C > 1, with and without shared
    experts, ``renorm_topk`` on and off, silu and gelu;
  * routing ties go to the lower expert id, as ``jax.lax.top_k``;
  * the capacity depends on how many tokens share the call: the same tokens
    routed together and in halves drop different pairs, in both packages;
  * the port's version of each case of ``tests/test_moe.py``, against the
    port's dense oracle ``moe_ref_dense``;
  * no host sync in the layer (the capacity comes from shapes, the dropped
    fraction stays a tensor)."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def make_params(d, cfg: TM.MoEConfig, seed):
    """The same weights as JAX and torch ``MoEParams`` (numpy seed)."""
    rng = np.random.default_rng(seed)
    E, f, fs = cfg.n_experts, cfg.d_ff_expert, cfg.d_ff_expert * cfg.n_shared_experts

    def arr(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    w = dict(w_router=arr((d, E), d), w_gate=arr((E, d, f), d), w_up=arr((E, d, f), d),
             w_down=arr((E, f, d), f),
             shared_gate=arr((d, fs), d) if fs else None,
             shared_up=arr((d, fs), d) if fs else None,
             shared_down=arr((fs, d), fs) if fs else None)
    jp = JM.MoEParams(**{k: None if v is None else jnp.asarray(v) for k, v in w.items()})
    tp = TM.MoEParams(**{k: None if v is None else torch.from_numpy(v) for k, v in w.items()})
    return jp, tp


def jax_cfg(cfg: TM.MoEConfig) -> JM.MoEConfig:
    return JM.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.capacity_factor,
                        cfg.n_shared_experts, cfg.renorm_topk)


def jax_moe(jp, cfg, x, act):
    fn = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    out, dropped = jax.jit(lambda p, x: JM.moe_layer(p, jax_cfg(cfg), x, fn))(
        jp, jnp.asarray(x))
    return np.asarray(out), np.asarray(dropped)


# (tokens, n_experts, top_k, capacity_factor, shared experts, renorm, act)
CASES = [
    (3, 8, 2, 1.0, 0, True, "silu"),        # C = 1 (int(0.75) -> max(1, 0))
    (4, 256, 8, 1.25, 1, True, "silu"),     # C = 1: deepseek-v3's routing at batch 4
    (40, 8, 2, 1.25, 1, True, "gelu"),      # C = 12
    (40, 8, 2, 0.3, 0, False, "silu"),      # C = 3, most pairs dropped
    (64, 16, 4, 1.25, 2, True, "silu"),     # C = 20, two shared experts
    (48, 8, 2, 1.5, 0, False, "gelu"),      # C = 18, raw top-k weights
]


@pytest.mark.parametrize("T,E,k,cf,shared,renorm,act", CASES)
def test_moe_layer_matches_jax(T, E, k, cf, shared, renorm, act):
    cfg = TM.MoEConfig(E, k, 16, cf, shared, renorm)
    jp, tp = make_params(32, cfg, seed=T + E)
    x = np.random.default_rng(T).standard_normal((T, 32)).astype(np.float32)
    j_out, j_dropped = jax_moe(jp, cfg, x, act)
    t_out, t_dropped = TM.moe_layer(tp, cfg, torch.from_numpy(x), act)
    assert isinstance(t_dropped, torch.Tensor) and t_dropped.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), j_out, **TOL)
    assert t_dropped.numpy().tobytes() == j_dropped.tobytes()


def test_leading_axes_and_ties_match_jax():
    """[B, S, d] input, and a router whose probabilities tie across experts:
    the lower expert id wins in both packages."""
    cfg = TM.MoEConfig(8, 2, 16, 1.25, 0, True)
    jp, tp = make_params(16, cfg, seed=3)
    w = np.asarray(jp.w_router).copy()
    w[:, 5] = w[:, 1]                          # experts 1 and 5 always tie
    w[:, 6] = w[:, 2]
    jp, tp = jp._replace(w_router=jnp.asarray(w)), tp._replace(w_router=torch.from_numpy(w))
    x = np.random.default_rng(4).standard_normal((2, 9, 16)).astype(np.float32)
    j_out, j_dropped = jax_moe(jp, cfg, x, "silu")
    t_out, t_dropped = TM.moe_layer(tp, cfg, torch.from_numpy(x))
    assert t_out.shape == (2, 9, 16)
    np.testing.assert_allclose(t_out.numpy(), j_out, **TOL)
    assert float(t_dropped) == float(j_dropped)
    _, ids = TM._route(tp, cfg, torch.from_numpy(x).reshape(-1, 16))
    _, j_ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x).reshape(-1, 16) @ jnp.asarray(w)), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


def test_capacity_depends_on_tokens_per_call():
    """C = max(1, int(T k cf / E)) counts the tokens sharing the call: the
    same 8 tokens routed together (C = 2) and as two calls of 4 (C = 1) drop
    different pairs, in the port as in the reference."""
    cfg = TM.MoEConfig(8, 2, 16, 1.25, 0, True)
    jp, tp = make_params(16, cfg, seed=5)
    x = np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)
    whole_j, whole_jd = jax_moe(jp, cfg, x, "silu")
    whole_t, whole_td = TM.moe_layer(tp, cfg, torch.from_numpy(x))
    halves_t = [TM.moe_layer(tp, cfg, torch.from_numpy(x[i:i + 4])) for i in (0, 4)]
    halves_j = [jax_moe(jp, cfg, x[i:i + 4], "silu") for i in (0, 4)]
    np.testing.assert_allclose(whole_t.numpy(), whole_j, **TOL)
    assert float(whole_td) == float(whole_jd)
    for (o_t, d_t), (o_j, d_j) in zip(halves_t, halves_j):
        np.testing.assert_allclose(o_t.numpy(), o_j, **TOL)
        assert float(d_t) == float(d_j)
    halves = torch.cat([o for o, _ in halves_t])
    assert not torch.allclose(halves, whole_t, atol=1e-3)


# the port's version of each case of tests/test_moe.py

def _params(d, cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return TM.init_moe_params(gen, d, cfg)


def test_moe_matches_dense_oracle_at_high_capacity():
    """No pair dropped. The reference asserts ``dropped == 0.0`` on its
    eager layer; compiled, XLA fuses ``1 - 80 * f32(1/80)`` into one FMA and
    gives -2^-26, and the port gives the compiled value: so the check is
    that value, and that it is below one pair's share (1/80) by far."""
    cfg = TM.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=8.0)
    params = _params(32, cfg, 0)
    x = torch.randn(4, 10, 32, generator=torch.Generator().manual_seed(1))
    out, dropped = TM.moe_layer(params, cfg, x)
    jp = JM.MoEParams(*(None if t is None else jnp.asarray(t.numpy()) for t in params))
    assert float(dropped) == float(jax_moe(jp, cfg, x.numpy(), "silu")[1]) == -2.0 ** -26
    assert abs(float(dropped)) < 0.5 / 80
    torch.testing.assert_close(out, TM.moe_ref_dense(params, cfg, x), rtol=2e-4, atol=2e-4)


def test_moe_shared_experts():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=8.0,
                       n_shared_experts=1)
    params = _params(16, cfg, 2)
    x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(3))
    out, _ = TM.moe_layer(params, cfg, x)
    torch.testing.assert_close(out, TM.moe_ref_dense(params, cfg, x), rtol=2e-4, atol=2e-4)


def test_capacity_drops_tokens():
    cfg_low = TM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=0.3)
    cfg_high = TM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=4.0)
    params = _params(16, cfg_low, 4)
    x = torch.randn(2, 32, 16, generator=torch.Generator().manual_seed(5))
    _, d_low = TM.moe_layer(params, cfg_low, x)
    _, d_high = TM.moe_layer(params, cfg_high, x)
    assert float(d_low) > 0.0
    assert float(d_high) <= float(d_low)


def test_router_weights_renormalized():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=8.0)
    params = _params(16, cfg, 6)
    # identical experts: the output is independent of the routing when the
    # weights sum to 1
    params = params._replace(**{f: getattr(params, f)[:1].expand_as(getattr(params, f))
                                for f in ("w_gate", "w_up", "w_down")})
    x = torch.randn(1, 5, 16, generator=torch.Generator().manual_seed(7))
    out, _ = TM.moe_layer(params, cfg, x)
    h = torch.nn.functional.silu(x @ params.w_gate[0]) * (x @ params.w_up[0])
    torch.testing.assert_close(out, h @ params.w_down[0], rtol=2e-4, atol=2e-4)


def test_no_host_sync_in_the_layer():
    src = (ROOT / "src" / "repro_torch" / "models" / "moe.py").read_text()
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "bool(", "nonzero("):
        assert call not in src, call
