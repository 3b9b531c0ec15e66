"""The MoE family and q-LoRA through the port's decoder stack and serving
step loop against the JAX package, on the smoke configs of deepseek-v3-mla
(MLA with q-LoRA, 4 experts top-2 plus a shared expert), mixtral-8x7b
(sliding window, MoE), qwen3-moe-30b-a3b (MoE) and granite-3-2b (dense GQA,
d_head 16 at smoke size), with the same bridged weights and prompts:

  * ``project_q`` with q-LoRA within 1e-6 of the reference's;
  * ``forward`` logits within rtol / atol 1e-4 of the jitted JAX forward, and
    its summed dropped fraction exactly equal;
  * ``serve.generate`` for 8 steps on the ``kernel`` backend (CPU tensors:
    the plain versions): greedy tokens identical to the JAX ``generate``,
    prefill and first-step logits within 1e-4; deepseek on contiguous and
    paged caches, kv_splits 1 and 2, FMA (JAX: its reference backend) and
    AMLA (JAX: its Pallas kernels in interpret mode);
  * the ``serve`` command line on the CPU for each of the four, deepseek also
    with ``--paged``, ``--kv-splits 2`` and ``--rescale amla``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import mla as jmla
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import mla as tmla
from repro_torch.kernels import _lib
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["deepseek-v3-mla", "mixtral-8x7b", "qwen3-moe-30b-a3b", "granite-3-2b"]
B, S, GEN = 3, 12, 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX smoke params and the port's bridged copy."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return out


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)


def jax_first_logits(jcfg, jparams, prompts, first_token):
    state = JT.init_decode_state(jcfg, B, jserve._decode_capacity(jcfg, S, GEN))
    logits0, state = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, prompts, state)
    pos = jnp.full((B,), S, jnp.int32)
    logits1, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, first_token, state, pos)
    return np.asarray(logits0), np.asarray(logits1)


def check_generate(models, prompts, arch, jax_backend="ref", **over):
    jcfg, jparams, tparams = models[arch]
    jcfg = dataclasses.replace(jcfg, decode_backend=jax_backend,
                               use_kernels=jax_backend == "kernel", **over)
    j_toks, _ = jserve.generate(jcfg, jparams, jnp.asarray(prompts), GEN)
    tcfg = dataclasses.replace(t_smoke(arch), decode_backend="kernel", use_kernels=True,
                               **over)
    _lib.reset_launches()
    t_toks, tps, t_logits = tserve.generate(tcfg, tparams, torch.from_numpy(prompts), GEN,
                                            return_logits=True)
    assert sum(_lib.LAUNCHES.values()) == 0        # CPU tensors: plain versions only
    assert t_toks.shape == (B, GEN) and tps > 0 and torch.isfinite(t_logits).all()
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    l0, l1 = jax_first_logits(jcfg, jparams, prompts, jnp.asarray(np.asarray(j_toks)[:, 0]))
    np.testing.assert_allclose(t_logits[:, 0].numpy(), l0, **TOL)
    np.testing.assert_allclose(t_logits[:, 1].numpy(), l1, **TOL)
    return t_toks, t_logits


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_config_fields_and_counts_equal_reference(arch):
    for jc, tc in ((j_config(arch), t_config(arch)), (j_smoke(arch), t_smoke(arch))):
        assert (tc.moe is None) == (jc.moe is None)
        if tc.moe is not None:
            assert isinstance(tc.moe, TM.MoEConfig)
            assert dataclasses.astuple(tc.moe) == dataclasses.astuple(jc.moe)
        assert (tc.first_k_dense, tc.has_mlp) == (jc.first_k_dense, jc.has_mlp)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


def test_deepseek_full_layer_parameter_count():
    """deepseek-v3-mla cut to one full-width layer: 12.43 B parameters by
    the reference's count, of which 0.93 B are the tied embedding and 11.27 B
    the routed experts (45.1 GB in float32, read by every decode step)."""
    one = dataclasses.replace(t_config("deepseek-v3-mla"), n_layers=1)
    emb = one.vocab_size * one.d_model
    assert emb == 926_679_040
    assert round(one.param_count() / 1e9, 2) == 12.43
    m = one.moe
    experts = m.n_experts * 3 * one.d_model * m.d_ff_expert
    assert round(experts * 4 / 1e9, 1) == 45.1
    assert one.active_param_count() == one.param_count() - experts * (m.n_experts - m.top_k) \
        // m.n_experts


def test_project_q_lora_matches_jax(models):
    jcfg, jparams, tparams = models["deepseek-v3-mla"]
    jm = jax.tree.map(lambda a: a[0], jparams["scanned"][0]["mixer"])
    tm = tparams["layers"][0]["mixer"]
    assert tm.w_dq.shape == (64, 48) and tm.q_norm.shape == (48,)
    mc = dict(d_model=64, n_heads=4, d_head=16, d_rope=16, d_c=32, q_lora_rank=48)
    h = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    jq_c, jq_r = jmla.project_q(jm, jmla.MLAConfig(**mc), jnp.asarray(h), jnp.asarray(pos))
    tq_c, tq_r = tmla.project_q(tm, tmla.MLAConfig(**mc), torch.from_numpy(h),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(tq_c.numpy(), np.asarray(jq_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tq_r.numpy(), np.asarray(jq_r), rtol=1e-6, atol=1e-6)


def test_init_model_builds_moe_and_q_lora_layers():
    """The port's own init: MoE params on every layer of a MoE config (the
    reference's first_k_dense hint), q-LoRA weights on deepseek's MLA."""
    gen = torch.Generator().manual_seed(0)
    ds = TT.init_model(gen, t_smoke("deepseek-v3-mla"), device="cpu")
    assert all(isinstance(lp["mlp"], TM.MoEParams) for lp in ds["layers"])
    assert ds["layers"][0]["mlp"].shared_gate.shape == (64, 32)
    assert ds["layers"][0]["mixer"].w_dq.shape == (64, 48)
    cfg = dataclasses.replace(t_smoke("qwen3-moe-30b-a3b"), first_k_dense=1)
    qw = TT.init_model(gen, cfg, device="cpu")
    assert all(isinstance(lp["mlp"], TM.MoEParams) for lp in qw["layers"])
    assert qw["layers"][0]["mlp"].shared_gate is None


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch):
    jcfg, jparams, tparams = models[arch]
    tokens = np.random.RandomState(3).randint(0, 256, (2, 24)).astype(np.int32)
    j_logits, j_aux = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jparams, jnp.asarray(tokens))
    t_logits, t_aux = TT.forward(tparams, t_smoke(arch), torch.from_numpy(tokens).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    assert float(t_aux) == float(j_aux)
    if arch == "granite-3-2b":
        assert t_aux == 0.0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b", "granite-3-2b"])
def test_gqa_generate_matches_jax(models, prompts, arch):
    check_generate(models, prompts, arch)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_splits", [1, 2])
@pytest.mark.parametrize("rescale", ["fma", "amla"])
def test_deepseek_generate_matches_jax(models, prompts, paged, kv_splits, rescale):
    check_generate(models, prompts, "deepseek-v3-mla",
                   jax_backend="kernel" if rescale == "amla" else "ref",
                   kv_paged=paged, kv_splits=kv_splits, kv_rescale=rescale)


def test_deepseek_contiguous_and_paged_identical(models, prompts):
    """At block_n == page the two layouts run the same per-block arithmetic."""
    _, _, tparams = models["deepseek-v3-mla"]
    base = dataclasses.replace(t_smoke("deepseek-v3-mla"), kv_splits=2,
                               decode_backend="kernel", use_kernels=True)
    outs = [tserve.generate(dataclasses.replace(base, kv_paged=p), tparams,
                            torch.from_numpy(prompts), GEN, return_logits=True)
            for p in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2], outs[1][2])


@pytest.mark.parametrize("arch,flags", [
    ("deepseek-v3-mla", []), ("deepseek-v3-mla", ["--paged"]),
    ("deepseek-v3-mla", ["--kv-splits", "2", "--rescale", "amla"]),
    ("mixtral-8x7b", []), ("qwen3-moe-30b-a3b", []), ("granite-3-2b", [])])
def test_serve_main_cpu(capsys, arch, flags):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--backend", "kernel",
                 "--batch", "2", "--prompt-len", "10", "--gen", "3", *flags])
    out = capsys.readouterr().out
    assert arch in out and "generated (2, 3)" in out
    assert "token agreement vs BF16 pipeline" in out
