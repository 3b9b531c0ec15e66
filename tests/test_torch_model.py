"""The port's serving step loop on the mla-7b smoke config against the JAX
``serve.generate`` with the same (bridged) weights and prompts: prefill and
first-decode-step logits within 1e-4, greedy tokens identical over 8 steps,
and ``sample_logits``' masking equal to the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config as t_smoke
from repro_torch.core import kvcache as tkv
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

B, S, GEN = 3, 12, 8


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke("mla-7b"), kv_paged=True, decode_backend="ref")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, tparams, prompts


def _jax_logits(jcfg, jparams, prompts, first_token):
    """Prefill logits and the first decode step's logits from the reference."""
    state = JT.init_decode_state(jcfg, B, jserve._decode_capacity(jcfg, S, GEN))
    logits0, state = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, prompts, state)
    pos = jnp.full((B,), S, jnp.int32)
    logits1, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, first_token, state, pos)
    return np.asarray(logits0), np.asarray(logits1)


@pytest.mark.parametrize("kv_splits", [1, 2])
def test_generate_matches_jax(setup, kv_splits):
    jcfg, jparams, tparams, prompts = setup
    jcfg = dataclasses.replace(jcfg, kv_splits=kv_splits)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), kv_paged=True, kv_splits=kv_splits,
                               decode_backend="kernel", use_kernels=True)
    _lib.reset_launches()
    t_toks, tps, t_logits = tserve.generate(tcfg, tparams, torch.from_numpy(prompts),
                                            GEN, return_logits=True)
    assert sum(_lib.LAUNCHES.values()) == 0        # CPU tensors: plain versions only
    assert t_toks.shape == (B, GEN) and tps > 0
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    l0, l1 = _jax_logits(jcfg, jparams, prompts, jnp.asarray(np.asarray(j_toks)[:, 0]))
    np.testing.assert_allclose(t_logits[:, 0].numpy(), l0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_logits[:, 1].numpy(), l1, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(t_logits).all()


def test_ref_and_kernel_backends_agree(setup):
    _, _, tparams, prompts = setup
    base = dataclasses.replace(t_smoke("mla-7b"), kv_paged=True, kv_splits=1)
    outs = [tserve.generate(dataclasses.replace(base, decode_backend=b,
                                                use_kernels=b == "kernel"),
                            tparams, torch.from_numpy(prompts), GEN)[0]
            for b in ("ref", "kernel")]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


@pytest.mark.parametrize("fmt", ["int8", "none"])
def test_other_formats_match_jax(setup, fmt):
    jcfg, jparams, tparams, prompts = setup
    jcfg = dataclasses.replace(jcfg, kv_fmt=fmt, kv_splits=1)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), kv_paged=True, kv_fmt=fmt,
                               kv_splits=1, decode_backend="kernel", use_kernels=True)
    t_toks, _ = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))


def _captured_masking(monkeypatch, logits, temperature, top_k, top_p):
    seen = []
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x, axis=-1: seen.append(np.asarray(x))
                        or jnp.argmax(x, axis))
    jsteps.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), temperature,
                         top_k, top_p)
    return seen[0]


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8), (7, 0.5)])
def test_sample_logits_masking_matches_jax(monkeypatch, top_k, top_p):
    logits = (np.random.RandomState(1).standard_normal((4, 64)) * 3).astype(np.float32)
    j_masked = _captured_masking(monkeypatch, logits, 0.7, top_k, top_p)
    t_masked = tsteps.masked_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_allclose(t_masked.numpy(), j_masked, rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(0)
    draws = tsteps.sample_logits(torch.from_numpy(logits), g, 0.7, top_k, top_p)
    assert np.isfinite(t_masked.numpy()[np.arange(4), draws.numpy()]).all()


def test_greedy_and_eos_match_jax():
    logits = np.random.RandomState(2).standard_normal((5, 32)).astype(np.float32)
    logits[0, 3] = logits[0, 9] = 50.0            # a tie: first index wins in both
    t = tsteps.sample_logits(torch.from_numpy(logits), None)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jsteps.sample_logits(logits, None)))
    done = np.array([True, False, False, True, False])
    tok = np.array([1, 2, 7, 4, 7], np.int32)
    jt, jd = jsteps.apply_eos(jnp.asarray(tok), jnp.asarray(done), 7)
    tt, td = tsteps.apply_eos(torch.from_numpy(tok), torch.from_numpy(done), 7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_eos_early_stop_pads(setup):
    _, _, tparams, prompts = setup
    tcfg = dataclasses.replace(t_smoke("mla-7b"), kv_paged=True, kv_splits=1)
    toks, _ = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN)
    eos = int(toks[0, 1])
    toks_eos, _ = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN,
                                  eos_id=eos)
    assert toks_eos.shape == (B, GEN)
    for row, ref in zip(toks_eos.tolist(), toks.tolist()):
        cut = ref.index(eos) if eos in ref else GEN
        assert row[:cut + 1] == ref[:cut + 1]
        assert all(t == eos for t in row[cut:])


def test_config_copy_and_unported_paths():
    from repro.configs import get_config as j_get
    jc, tc = j_get("mla-7b"), get_config("mla-7b")
    assert jc.tie_embeddings                      # the port's unembedding is tied
    for f in ("name", "n_layers", "d_model", "n_heads", "d_head", "d_ff", "vocab_size",
              "layer_pattern", "rope_theta", "act", "page_size", "kv_fmt", "kv_splits",
              "kv_block_n", "kv_rescale", "kv_sink_tokens", "kv_paged", "kv_pool_pages",
              "prefill_chunk", "use_kernels", "decode_backend"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert (tc.mla.d_c, tc.mla.d_rope, tc.mla.q_lora_rank) == (
        jc.mla.d_c, jc.mla.d_rope, jc.mla.q_lora_rank)
    # the contiguous cache is the default layout, with the sink guard armed
    # only there (transformer.py:64-70)
    state = TT.init_decode_state(dataclasses.replace(t_smoke("mla-7b"), kv_sink_tokens=3),
                                 1, 16, device="cpu")
    assert isinstance(state["layers"][0], tkv.MLACache)
    assert state["layers"][0].sink_tokens == 3
    paged = TT.init_decode_state(dataclasses.replace(t_smoke("mla-7b"), kv_paged=True,
                                                     kv_sink_tokens=3), 1, 16, device="cpu")
    assert isinstance(paged["layers"][0], tkv.PagedMLAPool)
    with pytest.raises(ValueError, match="not ported"):
        get_config("deepseek-v3-mla")
    # the engine's flags whose modules are not ported yet exit at parse time
    for flags in (["--restartable"], ["--trace-out", "t.json"],
                  ["--host-tier-pages", "2", "--prefix-cache-pages", "2"]):
        with pytest.raises(SystemExit):
            tserve.main(["--smoke", "--engine", "--device", "cpu", *flags])
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--fused", "--device", "cpu"])


@pytest.mark.parametrize("kv_splits,sink_tokens,rescale", [
    (1, 0, "fma"), (2, 0, "fma"), (1, 4, "fma"), (2, 4, "fma"), (1, 0, "amla"),
    (2, 0, "amla")])
def test_contiguous_generate_matches_jax(setup, kv_splits, sink_tokens, rescale):
    """The reference's default serving path: the contiguous cache, with and
    without the sink guard, FMA and AMLA. JAX runs its reference backend for
    FMA and its Pallas kernels (interpret mode) for AMLA, whose reference
    backend is the einsum form without AMLA."""
    jcfg, jparams, tparams, prompts = setup
    jcfg = dataclasses.replace(jcfg, kv_paged=False, kv_splits=kv_splits,
                               kv_sink_tokens=sink_tokens, kv_rescale=rescale)
    if rescale == "amla":
        jcfg = dataclasses.replace(jcfg, decode_backend="kernel", use_kernels=True)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), kv_splits=kv_splits,
                               kv_sink_tokens=sink_tokens, kv_rescale=rescale,
                               decode_backend="kernel", use_kernels=True)
    t_toks, _, t_logits = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN,
                                          return_logits=True)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    l0, l1 = _jax_logits(jcfg, jparams, prompts, jnp.asarray(np.asarray(j_toks)[:, 0]))
    np.testing.assert_allclose(t_logits[:, 0].numpy(), l0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_logits[:, 1].numpy(), l1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_splits,rescale", [(1, "fma"), (2, "fma"), (2, "amla")])
def test_contiguous_and_paged_give_identical_tokens(setup, kv_splits, rescale):
    """At block_n == page the contiguous and paged kernels run the same
    per-block arithmetic: identical logits and greedy tokens (the reference
    asserts the tokens in tests/test_paged_splitkv.py)."""
    _, _, tparams, prompts = setup
    base = dataclasses.replace(t_smoke("mla-7b"), kv_splits=kv_splits, kv_rescale=rescale,
                               decode_backend="kernel", use_kernels=True)
    outs = [tserve.generate(dataclasses.replace(base, kv_paged=paged), tparams,
                            torch.from_numpy(prompts), GEN, return_logits=True)
            for paged in (False, True)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][2].numpy(), outs[1][2].numpy())


@pytest.mark.parametrize("flags", [[], ["--kv-splits", "2", "--rescale", "amla"],
                                   ["--sink-tokens", "3", "--block-n", "16"],
                                   ["--paged", "--block-n", "16", "--rescale", "amla"]])
def test_serve_main_cpu_default_contiguous(capsys, flags):
    tserve.main(["--smoke", "--backend", "kernel", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "10", "--gen", "3", *flags])
    out = capsys.readouterr().out
    kind = "paged" if "--paged" in flags else "contiguous"
    assert f"{kind} cache" in out and "generated (2, 3)" in out


def test_serve_main_cpu(capsys):
    tserve.main(["--smoke", "--paged", "--backend", "kernel", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "10", "--gen", "4", "--kv-splits", "2"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "token agreement vs BF16 pipeline" in out
