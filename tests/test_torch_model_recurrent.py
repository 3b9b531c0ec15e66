"""The recurrent families through the port's decoder stack and serving loops
against the JAX package on the smoke configs (recurrentgemma-9b: rglru,
rglru, swa over an MQA ring at the window; xlstm-1.3b: mlstm x 7, slstm),
with the same bridged weights and prompts:

  * every config field the port has equals the reference's, full and smoke;
  * ``forward`` within rtol / atol 1e-4 of the JAX ``forward``;
  * prefill, then teacher-forced decode over a bf16 cache, reproduces
    ``forward`` (tests/test_models.py:53-74, rtol / atol 5e-2);
  * ``serve.generate`` greedy tokens equal to the JAX ``generate``'s on the
    ``ref`` backend (the GQA parallel form, as the reference's) and on the
    ``kernel`` backend (#7's plain version on CPU tensors), prefill and
    first-step logits within 1e-4;
  * ``generate_fused`` equal to ``generate`` bit for bit (tokens and every
    step's logits), and to the JAX ``generate_fused``; with ``eos_id`` a
    finished row's recurrent state stays frozen (``_freeze_inactive``) while
    the other rows match the ungated run bit for bit;
  * ``serve`` on the CPU (step loop and ``--fused``), and ``--engine``
    refusing both, as the reference's engine does."""
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
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")
B, S, GEN = 3, 20, 8      # prompt past recurrentgemma's smoke window of 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return out


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)


def t_cfg(arch, backend="kernel", **over):
    return dataclasses.replace(t_smoke(arch), decode_backend=backend,
                               use_kernels=backend == "kernel", **over)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for jc, tc in ((j_config(arch), t_config(arch)), (j_smoke(arch), t_smoke(arch))):
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (arch, f.name)
        for prop in ("pattern_len", "n_superblocks", "remainder_kinds", "has_mlp"):
            assert getattr(tc, prop) == getattr(jc, prop), (arch, prop)
    assert t_config(arch).param_count() == j_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_layers_in_order(models, arch):
    """12 superblocks + the 2-layer tail (recurrentgemma), 6 superblocks
    (xlstm): the port's list in layer order; no MLP on the xLSTM cells."""
    jcfg, _, tparams = models[arch]
    assert len(tparams["layers"]) == jcfg.n_layers
    for kind, p in zip(t_smoke(arch).layer_kinds, tparams["layers"]):
        assert ("mlp" in p) == (kind not in ("mlstm", "slstm"))
    full = t_config(arch)
    assert len(full.layer_kinds) == full.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch):
    jcfg, jparams, tparams = models[arch]
    tokens = np.random.RandomState(3).randint(0, 256, (2, 24)).astype(np.int32)
    j_logits, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jparams, jnp.asarray(tokens))
    t_logits, aux = TT.forward(tparams, t_smoke(arch), torch.from_numpy(tokens).long())
    assert aux == 0.0
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_teacher_forced_decode_matches_forward(models, arch):
    tparams = models[arch][2]
    cfg = t_cfg(arch, kv_fmt="none")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (1, 16)).astype(np.int64))
    full, _ = TT.forward(tparams, cfg, tokens)
    state = TT.init_decode_state(cfg, 1, 64, device="cpu")
    _, state = TT.prefill(tparams, cfg, tokens[:, :12], state)
    for t in range(12, 15):
        lg, state = TT.decode_step(tparams, cfg, tokens[:, t], state,
                                   torch.full((1,), t, dtype=torch.int32))
        np.testing.assert_allclose(lg[0].numpy(), full[0, t].numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(models, prompts, arch, backend):
    jcfg, jparams, tparams = models[arch]
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    _lib.reset_launches()
    t_toks, tps, t_logits = tserve.generate(t_cfg(arch, backend), tparams,
                                            torch.from_numpy(prompts), GEN, return_logits=True)
    assert sum(_lib.LAUNCHES.values()) == 0        # CPU tensors: plain versions only
    assert t_toks.shape == (B, GEN) and tps > 0
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    state = JT.init_decode_state(jcfg, B, jserve._decode_capacity(jcfg, S, GEN))
    l0, state = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, jnp.asarray(prompts), state)
    l1, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, jnp.asarray(j_toks)[:, 0], state,
                                                   jnp.full((B,), S, jnp.int32))
    np.testing.assert_allclose(t_logits[:, 0].numpy(), np.asarray(l0), **TOL)
    np.testing.assert_allclose(t_logits[:, 1].numpy(), np.asarray(l1), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_fused_equals_generate_and_jax(models, prompts, arch):
    jcfg, jparams, tparams = models[arch]
    cfg, p = t_cfg(arch), torch.from_numpy(prompts)
    stats: dict = {}
    f_toks, _, f_logits = tserve.generate_fused(cfg, tparams, p, GEN, return_logits=True,
                                                stats=stats)
    assert stats["replays"] == 0 and stats["steps_timed"] == GEN - 2
    toks, _, logits = tserve.generate(cfg, tparams, p, GEN, return_logits=True)
    assert torch.equal(f_toks, toks) and torch.equal(f_logits, logits)
    j_toks, _ = jserve.generate_fused(jcfg, jparams, jnp.asarray(prompts), GEN)
    np.testing.assert_array_equal(f_toks.numpy(), np.asarray(j_toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_finished_freezes_the_recurrent_state(models, prompts, arch):
    """Row 0 emits EOS at step 2: gated and ungated runs give the same
    tokens; every recurrent leaf of row 0 differs from the ungated run's
    (it stopped updating) while every row that emits no EOS before the last
    step matches it bit for bit; the tokens equal the JAX
    ``make_fused_decode``'s."""
    jcfg, jparams, tparams = models[arch]
    cfg = t_cfg(arch)
    free, _ = tserve.generate(cfg, tparams, torch.from_numpy(prompts), GEN)
    eos = int(free[0, 2])
    max_len = tserve._decode_capacity(cfg, S, GEN)
    runs = {}
    for gate in (True, False):
        state = TT.init_decode_state(cfg, B, max_len, device="cpu")
        logits, state = TT.prefill(tparams, cfg, torch.from_numpy(prompts), state)
        fused = tsteps.make_fused_decode(cfg, GEN - 1, eos_id=eos, gate_finished=gate)
        toks, state_out, ok = fused(tparams, logits.argmax(-1).to(torch.int32), state,
                                    torch.full((B,), S, dtype=torch.int32))
        assert bool(ok) and state_out is state
        runs[gate] = (toks, state_out)
        first = logits.argmax(-1).to(torch.int32)
    assert torch.equal(runs[True][0], runs[False][0])
    assert (runs[True][0][0, 1:] == eos).all()
    seq = torch.cat([first[:, None], runs[True][0]], dim=1)
    live = ~(seq[:, :-1] == eos).any(dim=1)          # rows active at every step
    assert not live[0]
    kinds = cfg.layer_kinds
    for kind, g_layer, u_layer in zip(kinds, runs[True][1]["layers"],
                                      runs[False][1]["layers"]):
        if kind not in ("rglru", "mlstm", "slstm"):
            continue
        for g, u in zip(g_layer, u_layer):
            assert torch.equal(g[live], u[live])
            assert not torch.equal(g[0], u[0])
    jstate = JT.init_decode_state(jcfg, B, max_len)
    jl, jstate = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, jnp.asarray(prompts), jstate)
    jfused = jax.jit(jsteps.make_fused_decode(jcfg, GEN - 1, eos_id=eos))
    jtoks, _, _ = jfused(jparams, jnp.argmax(jl, -1).astype(jnp.int32), jstate,
                         jnp.full((B,), S, jnp.int32))
    np.testing.assert_array_equal(runs[True][0].numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("flags", [[], ["--fused"]], ids=["step-loop", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_cpu(capsys, arch, flags):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--backend", "kernel",
                 "--batch", "2", "--prompt-len", "20", "--gen", "4"] + flags)
    out = capsys.readouterr().out
    assert arch in out and ("fused-graph" in out) == bool(flags)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_recurrent_families(arch):
    """The engine drives the paged MLA path only (engine.py:235-239)."""
    with pytest.raises(ValueError, match="pure-MLA"):
        tserve.main(["--engine", "--arch", arch, "--smoke", "--device", "cpu"])
