"""The encoder families (whisper-base: 'dec' layers over a bidirectional
encoder; llama-3.2-vision-90b: 4 'attn' + 1 tanh-gated 'cross') through the
port against the JAX package on the smoke configs, with the same bridged
weights, prompts and aux embeddings (numpy-seeded):

  * ``layers.layer_norm`` and ``cross_attention_block`` within 1e-6;
  * every config field and the parameter count equal the reference's;
  * ``_run_encoder``, ``forward`` and ``prefill`` within 1e-5;
    ``_fill_cross_cache`` writes the reference's bytes;
  * ``decode_step`` under ``ref`` (the parallel form) and ``kernel`` (#7's
    plain version on CPU tensors) within 1e-5 of the JAX step; the cross
    caches and ``state["aux"]`` are the prefill's objects, unchanged;
  * greedy ``generate`` and ``generate_fused`` tokens equal the JAX ones;
  * ``serve`` runs both on the CPU; the engine refuses both.

Every cross layer's ``xgate`` is set to 0.5 in both packages' parameters
before comparing: it starts at zero (transformer.py:87), where tanh(0) = 0
makes a cross layer add nothing and no comparison would see its path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCHS = ("whisper-base", "llama-3.2-vision-90b")
B, S, GEN = 2, 10, 6
TOL = dict(rtol=1e-5, atol=1e-5)
XGATE = 0.5


def set_xgate(jparams, value=XGATE):
    """The JAX tree with every cross layer's gate set to ``value``."""
    def slot(p):
        return dict(p, xgate=jnp.full_like(p["xgate"], value)) if "xgate" in p else p
    return dict(jparams, scanned=[slot(p) for p in jparams.get("scanned", [])],
                tail=[slot(p) for p in jparams["tail"]])


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        jparams = set_xgate(JT.init_model(jax.random.PRNGKey(0), jcfg))
        out[arch] = (jcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return out


def inputs(cfg, seed=0, batch=B, seq=S):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    aux = rng.standard_normal((batch, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
    return toks, aux


def t_cfg(arch, backend="kernel", **over):
    return dataclasses.replace(t_smoke(arch), decode_backend=backend,
                               use_kernels=backend == "kernel", **over)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    gain, bias = rng.standard_normal((2, 48)).astype(np.float32)
    want = np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(gain), jnp.asarray(bias)))
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(gain), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_block_matches_jax(bias):
    """Queries from x [2, 5, 32], keys / values from 7 aux rows; Hkv 2, g 2,
    no mask, no RoPE; with and without QKV bias."""
    rng = np.random.default_rng(1)
    d, H, Hk, dh = 32, 4, 2, 8

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    arrs = dict(wq=w(d, H, dh), wk=w(d, Hk, dh), wv=w(d, Hk, dh), wo=w(H, dh, d),
                bq=w(H, dh) if bias else None, bk=w(Hk, dh) if bias else None,
                bv=w(Hk, dh) if bias else None)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    src = rng.standard_normal((2, 7, d)).astype(np.float32)
    cfg = dict(d_model=d, n_heads=H, n_kv_heads=Hk, d_head=dh, qkv_bias=bias)
    jp = JL.AttnParams(**{k: None if v is None else jnp.asarray(v) for k, v in arrs.items()})
    tp = TL.AttnParams(**{k: None if v is None else torch.from_numpy(v)
                          for k, v in arrs.items()})
    want = np.asarray(JL.cross_attention_block(jp, JL.AttnConfig(**cfg), jnp.asarray(x),
                                               jnp.asarray(src)))
    got = TL.cross_attention_block(tp, TL.AttnConfig(**cfg), torch.from_numpy(x),
                                   torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    """Full and smoke configs field for field; the parameter count
    (encoder included) equal; vision at 5 of 100 layers (chip_smoke's cut)
    is 6.38 B parameters."""
    for jc, tc in ((j_config(arch), t_config(arch)), (j_smoke(arch), t_smoke(arch))):
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (arch, f.name)
        assert tc.param_count() == jc.param_count()
    cut = dataclasses.replace(t_config("llama-3.2-vision-90b"), n_layers=5)
    assert round(cut.param_count() / 1e9, 2) == 6.38
    assert t_config("whisper-base").param_count() == 83_177_984


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_layers(models, arch):
    """The port's layer list carries each kind's fields; whisper's encoder
    is a list of its 'attn' layers; a cross cache's capacity is the aux
    rows rounded up to the page (24 -> 32 at the smoke page of 16)."""
    jcfg, _, tparams = models[arch]
    cfg = t_smoke(arch)
    for kind, p in zip(cfg.layer_kinds, tparams["layers"]):
        assert ("xgate" in p) == (kind == "cross")
        assert ("cross" in p) == ("ln_cross" in p) == (kind == "dec")
        if kind == "cross":
            assert torch.all(p["xgate"] == XGATE)
    assert len(tparams.get("encoder", [])) == cfg.encoder_layers
    assert ("enc_ln_f" in tparams) == bool(cfg.encoder_layers)
    state = TT.init_decode_state(cfg, B, 64, device="cpu")
    assert state["aux"] is None
    for kind, st in zip(cfg.layer_kinds, state["layers"]):
        if kind in ("cross", "dec"):
            cross = st if kind == "cross" else st["cross"]
            assert cross.capacity == 32 and (cross.slot_pos == -1).all()
    fresh = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.all(p["xgate"] == 0) for p in fresh["layers"] if "xgate" in p)


def test_run_encoder_matches_jax(models):
    jcfg, jparams, tparams = models["whisper-base"]
    _, aux = inputs(jcfg)
    want = jax.jit(lambda p, a: JT._run_encoder(p, jcfg, a))(jparams, jnp.asarray(aux))
    got = TT._run_encoder(tparams, t_smoke("whisper-base"), torch.from_numpy(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert TT._run_encoder(tparams, t_smoke("llama-3.2-vision-90b"), None) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch):
    jcfg, jparams, tparams = models[arch]
    toks, aux = inputs(jcfg, seed=3, seq=12)
    want, _ = jax.jit(lambda p, t, a: JT.forward(p, jcfg, t, a))(
        jparams, jnp.asarray(toks), jnp.asarray(aux))
    got, dropped = TT.forward(tparams, t_smoke(arch), torch.from_numpy(toks),
                              torch.from_numpy(aux))
    assert dropped == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="aux_embed"):
        TT.forward(tparams, t_smoke(arch), torch.from_numpy(toks))


def _jax_prefill(jcfg, jparams, toks, aux, max_len):
    state = JT.init_decode_state(jcfg, toks.shape[0], max_len)
    return jax.jit(jsteps.make_prefill_step(jcfg))(jparams, jnp.asarray(toks), state,
                                                   jnp.asarray(aux))


def _cross_caches(cfg, state):
    return [(i, st if kind == "cross" else st["cross"])
            for i, (kind, st) in enumerate(zip(cfg.layer_kinds, state["layers"]))
            if kind in ("cross", "dec")]


def _jax_layer_states(jcfg, jstate):
    """The reference's per-layer states in layer order (the port's list)."""
    out = []
    n = jcfg.n_superblocks
    for i in range(n):
        out += [jax.tree.map(lambda a: np.asarray(a)[i], s) for s in jstate["scanned"]]
    return out + [jax.tree.map(np.asarray, s) for s in jstate["tail"]]


def _raw(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cross_cache_match_jax(models, arch):
    """Last-token logits and ``state["aux"]`` within 1e-5; every cross
    cache's fp8 K / V codes, slot positions and lengths the reference's, its
    scales within 1e-6 (the aux rows come out of the encoder, whose float32
    sums round apart from XLA's); fed the reference's aux rows,
    ``_fill_cross_cache`` writes the reference's bytes exactly."""
    jcfg, jparams, tparams = models[arch]
    toks, aux = inputs(jcfg)
    j_logits, jstate = _jax_prefill(jcfg, jparams, toks, aux, 32)
    cfg = t_cfg(arch)
    state = TT.init_decode_state(cfg, B, 32, device="cpu")
    logits, state = TT.prefill(tparams, cfg, torch.from_numpy(toks), state,
                               torch.from_numpy(aux))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(state["aux"].numpy(), np.asarray(jstate["aux"]), **TOL)
    j_layers = _jax_layer_states(jcfg, jstate)
    j_aux = np.asarray(jstate["aux"])
    caches = _cross_caches(cfg, state)
    assert caches
    fill = jax.jit(lambda p, a, c: JT._fill_cross_cache(p, jcfg, a, c))
    j_params = _jax_layer_params(jcfg, jparams)
    for i, cache in caches:
        kind = cfg.layer_kinds[i]
        jc = j_layers[i] if kind == "cross" else j_layers[i]["cross"]
        want = bridge.gqa_cache_from_jax(jc)
        for f in ("k", "v", "slot_pos", "seq_lens"):
            assert torch.equal(_raw(getattr(cache, f)), _raw(getattr(want, f))), (i, f)
        for f in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(cache, f).numpy(), getattr(want, f).numpy(),
                                       rtol=1e-6, atol=0)
        assert int(cache.seq_lens[0]) == jcfg.n_aux_tokens
        # the same aux rows in: the same bytes out
        name = "mixer" if kind == "cross" else "cross"
        empty = JT.init_decode_state(jcfg, B, 32)
        j_empty = _jax_layer_states(jcfg, empty)[i]
        j_empty = j_empty if kind == "cross" else j_empty["cross"]
        j_filled = bridge.gqa_cache_from_jax(jax.tree.map(np.asarray, fill(
            j_params[i][name], jnp.asarray(j_aux), jax.tree.map(jnp.asarray, j_empty))))
        t_empty = TT.init_decode_state(cfg, B, 32, device="cpu")["layers"][i]
        t_filled = TT._fill_cross_cache(tparams["layers"][i][name], cfg,
                                        torch.from_numpy(j_aux.copy()),
                                        t_empty if kind == "cross" else t_empty["cross"])
        for f in t_filled._fields:
            assert torch.equal(_raw(getattr(t_filled, f)), _raw(getattr(j_filled, f))), (i, f)


def _jax_layer_params(jcfg, jparams):
    out = []
    for i in range(jcfg.n_superblocks):
        out += [jax.tree.map(lambda a: a[i], s) for s in jparams["scanned"]]
    return out + list(jparams["tail"])


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(models, arch, backend):
    """Two decode steps from one bridged prefill state within 1e-5 of the
    JAX steps (the reference's parallel form): under ``ref`` the port's
    parallel form, under ``kernel`` #7's plain version (CPU tensors: no
    launch). The cross caches and ``aux`` are never replaced or written."""
    jcfg, jparams, tparams = models[arch]
    toks, aux = inputs(jcfg, seed=5)
    j_logits, jstate = _jax_prefill(jcfg, jparams, toks, aux, 32)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    cfg = t_cfg(arch, backend)
    state = TT.init_decode_state(cfg, B, 32, device="cpu")
    _, state = TT.prefill(tparams, cfg, torch.from_numpy(toks), state, torch.from_numpy(aux))
    before = [(i, c, [t.clone() for t in c]) for i, c in _cross_caches(cfg, state)]
    aux_t = state["aux"]
    tok = np.argmax(np.asarray(j_logits), -1).astype(np.int32)
    _lib.reset_launches()
    for t in range(2):
        pos = np.full((B,), S + t, np.int32)
        j_logits, jstate = jdec(jparams, jnp.asarray(tok), jstate, jnp.asarray(pos))
        logits, state = TT.decode_step(tparams, cfg, torch.from_numpy(tok).long(), state,
                                       torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
        tok = np.argmax(np.asarray(j_logits), -1).astype(np.int32)
    assert sum(_lib.LAUNCHES.values()) == 0
    assert state["aux"] is aux_t
    after = dict(_cross_caches(cfg, state))
    for i, cache, copy in before:
        assert after[i] is cache
        assert all(torch.equal(a, b) for a, b in zip(cache, copy))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_fused_match_jax(models, arch):
    """Greedy tokens of ``generate`` (kernel backend) and ``generate_fused``
    equal the JAX ``generate``'s; the fused loop equals the step loop bit
    for bit (tokens and every step's logits) and the JAX ``generate_fused``."""
    jcfg, jparams, tparams = models[arch]
    toks, aux = inputs(jcfg, seed=7)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(toks), GEN,
                                aux_embed=jnp.asarray(aux))
    cfg, p, a = t_cfg(arch), torch.from_numpy(toks), torch.from_numpy(aux)
    g_toks, _, g_logits = tserve.generate(cfg, tparams, p, GEN, aux_embed=a,
                                          return_logits=True)
    np.testing.assert_array_equal(g_toks.numpy(), np.asarray(j_toks))
    f_toks, _, f_logits = tserve.generate_fused(cfg, tparams, p, GEN, aux_embed=a,
                                                return_logits=True)
    assert torch.equal(f_toks, g_toks) and torch.equal(f_logits, g_logits)
    jf_toks, _ = jserve.generate_fused(jcfg, jparams, jnp.asarray(toks), GEN,
                                       aux_embed=jnp.asarray(aux))
    np.testing.assert_array_equal(f_toks.numpy(), np.asarray(jf_toks))


@pytest.mark.parametrize("flags", [[], ["--fused"]], ids=["step-loop", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_cpu(capsys, arch, flags):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--backend", "kernel",
                 "--batch", "2", "--prompt-len", "12", "--gen", "4"] + flags)
    out = capsys.readouterr().out
    assert arch in out and ("fused-graph" in out) == bool(flags)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_encoder_families(arch):
    """The engine drives the paged MLA path only (engine.py:235-239)."""
    with pytest.raises(ValueError, match="aux tokens .* are not pure-MLA"):
        tserve.main(["--engine", "--arch", arch, "--smoke", "--device", "cpu"])
