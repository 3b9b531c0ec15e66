"""The port's optimizer pieces against the reference's on the same inputs
(``adamw_update`` and ``warmup_cosine`` eagerly, op by op, as the
reference's own tests call them), and held to the assertions of the
reference's tests of them:

  * ``adamw_update``: every elementwise float32 step bitwise (the clip at
    exactly 1 and at a norm past it, steps 1..5, a bf16 parameter);
    ``grad_norm`` (a sum whose order differs) within 1e-6;
  * ``warmup_cosine``: the warmup bitwise, the cosine within 4 float32 ulps
    (``cos`` is XLA's own approximation, and ``1 + cos`` near its end
    cancels up to 2 bits);
  * ``compress`` / ``decompress`` / ``compress_tree`` / ``decompress_tree``
    with error feedback bitwise over 20 steps;
  * ``StragglerDetector`` (a numpy copy) flag for flag;
  * tests/test_train_loop.py:26-55 and tests/test_grad_compression.py,
    assertion for assertion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import grad_compression as JG
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro.runtime import straggler as JS
from repro_torch.optim import adamw as TA
from repro_torch.optim import grad_compression as TG
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import straggler as TSG


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "b": [(rng.standard_normal(9) * scale).astype(np.float32)]}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {"w": torch.from_numpy(tree["w"]), "b": [torch.from_numpy(tree["b"][0])]}


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype == np.float32 else np.uint16)


@pytest.mark.parametrize("grad_clip", [1e9, 0.5], ids=["clip-1", "clip-norm"])
def test_adamw_update_matches_jax_bitwise(grad_clip):
    """Five steps on the same gradients: with the clip at exactly 1 every
    new parameter and moment equals the reference's bit for bit. Past the
    clip the factor is grad_clip / (norm + 1e-9), and the norm is a sum
    whose order differs: within 1e-6 there."""
    cfg = dict(lr=1e-2, grad_clip=grad_clip)
    jc, tc = JA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    params = _tree(0)
    jp, tp = _j(params), _t(params)
    js, ts = JA.init_adamw(jp), TA.init_adamw(tp)
    for step in range(5):
        grads = _tree(10 + step, scale=0.3)
        jp, js, jm = JA.adamw_update(jc, _j(grads), js, jp, 0.5)
        tp, ts, tm = TA.adamw_update(tc, _t(grads), ts, tp, 0.5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert np.float32(float(tm["lr"])) == np.float32(jm["lr"])
        assert int(ts.step) == int(js.step)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(TA.tree_leaves(got), jax.tree.leaves(want)):
                if grad_clip > 1e6:
                    assert np.array_equal(_bits(a.numpy()), _bits(b)), step
                else:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_adamw_keeps_a_bf16_parameter_bf16():
    """A bf16 parameter: the update in float32, cast back, bitwise."""
    w = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    g = np.random.default_rng(4).standard_normal(16).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    cfg = dict(grad_clip=1e9)
    jnew, _, _ = JA.adamw_update(JA.AdamWConfig(**cfg), {"w": jnp.asarray(g)},
                                 JA.init_adamw(jp), jp)
    tnew, ts, _ = TA.adamw_update(TA.AdamWConfig(**cfg), {"w": torch.from_numpy(g)},
                                  TA.init_adamw(tp), tp)
    assert tnew["w"].dtype == torch.bfloat16 and ts.mu["w"].dtype == torch.float32
    assert np.array_equal(tnew["w"].view(torch.int16).numpy(),
                          np.asarray(jnew["w"]).view(np.int16))


def test_warmup_cosine_matches_jax():
    for step in range(0, 121):
        kw = dict(warmup_steps=10, total_steps=100)
        got, want = float(warmup_cosine(step, **kw)), float(j_warmup_cosine(step, **kw))
        if step < 10:
            assert got == want, step
        else:
            assert abs(got - want) <= 4 * np.spacing(np.float32(want)), step


def test_compression_with_error_feedback_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    jr = jnp.zeros(64)
    tr = torch.zeros(64)
    for _ in range(20):
        g = (rng.standard_normal(64) * 0.1).astype(np.float32)
        jq, js, jr = JG.compress(jnp.asarray(g), jr)
        tq, ts, tr = TG.compress(torch.from_numpy(g), tr)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(_bits(ts.numpy()), _bits(js))
        assert np.array_equal(_bits(tr.numpy()), _bits(jr))
        assert np.array_equal(_bits(TG.decompress(tq, ts).numpy()),
                              _bits(JG.decompress(jq, js)))
    grads = _tree(6)
    jpay, jst = JG.compress_tree(_j(grads), JG.init_ef_state(_j(grads)))
    tpay, tst = TG.compress_tree(_t(grads), TG.init_ef_state(_t(grads)))
    for a, b in zip(TA.tree_leaves(TG.decompress_tree(tpay)),
                    jax.tree.leaves(JG.decompress_tree(jpay))):
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    for a, b in zip(TA.tree_leaves(tst.residual), jax.tree.leaves(jst.residual)):
        assert np.array_equal(_bits(a.numpy()), _bits(b))


def test_straggler_detector_matches_jax():
    rng = np.random.default_rng(7)
    cfg = dict(warmup_steps=2, threshold=1.3)
    j, t = JS.StragglerDetector(JS.StragglerConfig(**cfg), 6), \
        TSG.StragglerDetector(TSG.StragglerConfig(**cfg), 6)
    for step in range(30):
        times = rng.uniform(0.9, 1.1, 6)
        if step >= 8:
            times[[1, 4]] *= 1.8
        assert t.update(times) == j.update(times)
        np.testing.assert_array_equal(t.ewma, j.ewma)
    assert t.flagged == j.flagged and t.flagged


# the reference's own assertions (tests/test_train_loop.py:26-55)
def test_adamw_descends_quadratic():
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = TA.init_adamw(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, m = TA.adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.1
    assert float(m["grad_norm"]) >= 0


def test_grad_clip_bounds_update():
    cfg = TA.AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = TA.init_adamw(params)
    new, state, m = TA.adamw_update(cfg, {"w": torch.full((4,), 1e6)}, state, params)
    assert float(m["grad_norm"]) > 1e5
    assert torch.isfinite(new["w"]).all()


def test_schedule_shape():
    assert float(warmup_cosine(0, warmup_steps=10, total_steps=100)) == 0.0
    assert abs(float(warmup_cosine(10, warmup_steps=10, total_steps=100)) - 1.0) < 1e-5
    end = float(warmup_cosine(100, warmup_steps=10, total_steps=100))
    assert 0.05 < end < 0.15


# the reference's own assertions (tests/test_grad_compression.py)
def test_single_step_error_bounded():
    g = torch.randn(256, generator=torch.Generator().manual_seed(0))
    q, s, resid = TG.compress(g, torch.zeros_like(g))
    rt = TG.decompress(q, s)
    assert float((rt - g).abs().max()) <= float(s) * 0.5 + 1e-6
    np.testing.assert_allclose((rt + resid).numpy(), g.numpy(), rtol=1e-5, atol=1e-6)


def test_error_feedback_sum_converges():
    gen = torch.Generator().manual_seed(1)
    resid, true_sum, comp_sum = torch.zeros(64), torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = torch.randn(64, generator=gen) * 0.1
        true_sum = true_sum + g
        q, s, resid = TG.compress(g, resid)
        comp_sum = comp_sum + TG.decompress(q, s)
    np.testing.assert_allclose((comp_sum + resid).numpy(), true_sum.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_tree_roundtrip():
    grads = {"a": torch.ones((4, 4)), "b": [torch.full((3,), -2.0)]}
    payload, state2 = TG.compress_tree(grads, TG.init_ef_state(grads))
    out = TG.decompress_tree(payload)
    for a, b in zip(TA.tree_leaves(grads), TA.tree_leaves(out)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.02, atol=0.02)
