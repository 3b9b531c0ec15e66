"""The dense GQA family through the port's decoder stack and serving step loop
against the JAX package on the smoke configs (llama3.2-3b and qwen2.5-3b
here, gemma3-27b's sliding window in ``test_torch_gqa_model_gemma.py``), with
the same bridged weights and prompts:

  * every config field the port has equals the reference's, full and smoke;
  * ``serve.generate`` for 8 steps on the ``kernel`` backend (CPU tensors:
    the plain versions, no launch): greedy tokens identical to the JAX
    ``generate``, prefill and first-step logits within rtol / atol 1e-4 (the
    JAX model decodes through the parallel form, the port through the
    pipeline form; the two differ only by P's fp8 rounding);
  * ``forward`` within 1e-4 of the JAX ``forward``;
  * teacher-forced ``kv_fmt="none"`` decode after prefill reproduces
    ``forward`` (tests/test_models.py:53-74);
  * the ``serve`` command line on the CPU, and ``--engine`` refusing a
    non-MLA model ("pure-MLA")."""
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
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

GEN = 8
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_model(arch, seed=0, bias_scale=0.0):
    """JAX smoke params (QKV biases drawn at ``bias_scale`` when the config
    has them, so they are exercised) and the port's bridged copy."""
    jcfg = j_smoke(arch)
    jparams = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    if bias_scale and jcfg.qkv_bias:
        rng = np.random.default_rng(seed)

        def draw(p):
            return p._replace(**{f: jnp.asarray(rng.standard_normal(getattr(p, f).shape)
                                                 .astype(np.float32) * bias_scale)
                                 for f in ("bq", "bk", "bv")})
        jparams["scanned"] = [{**slot, "mixer": draw(slot["mixer"])}
                              for slot in jparams["scanned"]]
    return jcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def jax_first_logits(jcfg, jparams, prompts, first_token, gen=GEN):
    """Prefill logits and the first decode step's logits from the reference."""
    B, S = prompts.shape
    state = JT.init_decode_state(jcfg, B, jserve._decode_capacity(jcfg, S, gen))
    logits0, state = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, prompts, state)
    pos = jnp.full((B,), S, jnp.int32)
    logits1, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, first_token, state, pos)
    return np.asarray(logits0), np.asarray(logits1)


def check_generate(arch, fmt, B, S, bias_scale=0.0):
    jcfg, jparams, tparams = jax_model(arch, bias_scale=bias_scale)
    jcfg = dataclasses.replace(jcfg, kv_fmt=fmt)
    prompts = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    tcfg = dataclasses.replace(t_smoke(arch), kv_fmt=fmt, decode_backend="kernel",
                               use_kernels=True)
    _lib.reset_launches()
    t_toks, tps, t_logits = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN,
                                            return_logits=True)
    assert sum(_lib.LAUNCHES.values()) == 0        # CPU tensors: plain versions only
    assert t_toks.shape == (B, GEN) and tps > 0
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    l0, l1 = jax_first_logits(jcfg, jparams, prompts, jnp.asarray(np.asarray(j_toks)[:, 0]))
    np.testing.assert_allclose(t_logits[:, 0].numpy(), l0, **TOL)
    np.testing.assert_allclose(t_logits[:, 1].numpy(), l1, **TOL)
    assert torch.isfinite(t_logits).all()


def check_forward(arch, S, bias_scale=0.0):
    jcfg, jparams, tparams = jax_model(arch, seed=3, bias_scale=bias_scale)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    j_logits, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jparams, jnp.asarray(tokens))
    t_logits, aux = TT.forward(tparams, t_smoke(arch), torch.from_numpy(tokens).long())
    assert aux == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


def check_teacher_forced(arch, S, bias_scale=0.0):
    """Decode over a bf16 cache after prefill reproduces forward's logits
    (the reference's gate, rtol / atol 5e-2: the cache holds bf16 K and V)."""
    _, _, tparams = jax_model(arch, seed=1, bias_scale=bias_scale)
    cfg = dataclasses.replace(t_smoke(arch), kv_fmt="none", decode_backend="kernel",
                              use_kernels=True)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, S + 4)).astype(np.int64))
    full, _ = TT.forward(tparams, cfg, tokens)
    state = TT.init_decode_state(cfg, 1, 64, device="cpu")
    _, state = TT.prefill(tparams, cfg, tokens[:, :S], state)
    for t in range(S, S + 3):
        lg, state = TT.decode_step(tparams, cfg, tokens[:, t], state,
                                   torch.full((1,), t, dtype=torch.int32))
        np.testing.assert_allclose(lg[0].numpy(), full[0, t].numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2.5-3b", "gemma3-27b", "mla-7b",
                                  "granite-3-2b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
                                  "deepseek-v3-mla"])
def test_config_fields_equal_reference(arch):
    fields = [f.name for f in dataclasses.fields(t_config(arch))]
    for jc, tc in ((j_config(arch), t_config(arch)), (j_smoke(arch), t_smoke(arch))):
        for f in fields:
            t_val, j_val = getattr(tc, f), getattr(jc, f)
            if dataclasses.is_dataclass(t_val):          # MLADims: a class of each package
                t_val, j_val = dataclasses.astuple(t_val), dataclasses.astuple(j_val)
            assert t_val == j_val, (arch, f)
        for prop in ("pattern_len", "n_superblocks", "remainder_kinds"):
            assert getattr(tc, prop) == getattr(jc, prop), (arch, prop)
        assert tc.layer_kinds == tuple(tc.layer_pattern[i % tc.pattern_len]
                                       for i in range(tc.n_layers))


def test_arch_ids_in_reference_order():
    from repro.configs import ARCH_IDS as J_IDS
    assert ARCH_IDS == J_IDS            # all 12, the encoder families included


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "none"])
def test_llama_generate_matches_jax(fmt):
    check_generate("llama3.2-3b", fmt, B=3, S=12)


def test_qwen_generate_matches_jax():
    check_generate("qwen2.5-3b", "fp8_e4m3", B=3, S=12, bias_scale=0.5)


@pytest.mark.parametrize("arch,bias", [("llama3.2-3b", 0.0), ("qwen2.5-3b", 0.5)])
def test_forward_matches_jax(arch, bias):
    check_forward(arch, S=24, bias_scale=bias)


@pytest.mark.parametrize("arch,bias", [("llama3.2-3b", 0.0), ("qwen2.5-3b", 0.5)])
def test_teacher_forced_decode_reproduces_forward(arch, bias):
    check_teacher_forced(arch, S=12, bias_scale=bias)


def test_serve_main_cpu_llama(capsys):
    tserve.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--backend",
                 "kernel", "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    out = capsys.readouterr().out
    assert "llama3.2-3b" in out and "generated (2, 3)" in out
    assert "token agreement vs BF16 pipeline" in out


def test_serve_engine_refuses_gqa():
    with pytest.raises(ValueError, match="pure-MLA"):
        tserve.main(["--engine", "--arch", "llama3.2-3b", "--smoke", "--device", "cpu"])
    cfg = t_smoke("llama3.2-3b")
    with pytest.raises(NotImplementedError, match="pure-MLA"):
        TT.verify_step({}, cfg, torch.zeros((1, 2), dtype=torch.long), {},
                       torch.zeros((1,), dtype=torch.int32))
