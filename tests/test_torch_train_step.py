"""One ``make_train_step`` of the port against the reference's (jitted, no
mesh) on the same bridged weights and batch: the new parameters, the AdamW
moments and step, and the metrics (loss, ce, moe_dropped, grad_norm, lr)
within 1e-5; then a resumed step, from the reference's parameters and
optimizer state after that step bridged into the port
(``bridge.opt_state_from_jax``), within 1e-5 again. whisper-base's smoke
config (encoder, aux embeddings, xgate-free 'dec' layers) and
llama-3.2-vision-90b's (tanh-gated cross layers, xgate 0.5), warmup 2 of
10 steps, at steps 3 and 4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro.optim.adamw import init_adamw as j_init_adamw
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import steps as TS
from repro_torch.optim.adamw import AdamWState, init_adamw
from torch_grad_check import batch, jax_model

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want_np, what):
    want = flatten(bridge.params_from_jax(want_np))
    got = flatten(got)
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"{what} {path}", **TOL)


def _check(tp, topt, tm, jp, jopt, jm):
    _close(tp, jax.tree.map(np.asarray, jp), "params")
    _close(topt.mu, jax.tree.map(np.asarray, jopt.mu), "mu")
    _close(topt.nu, jax.tree.map(np.asarray, jopt.nu), "nu")
    assert int(topt.step) == int(jopt.step)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_train_step_and_resumed_step_match_jax(arch):
    jcfg, jparams, tparams = jax_model(arch)
    toks, labels, aux = batch(jcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if aux is not None:
        jb["aux_embed"], tb["aux_embed"] = jnp.asarray(aux), torch.from_numpy(aux)
    jstep = jax.jit(JS.make_train_step(jcfg, warmup_steps=2, total_steps=10))
    tstep = TS.make_train_step(t_smoke(arch), warmup_steps=2, total_steps=10)
    jp1, jo1, jm1 = jstep(jparams, j_init_adamw(jparams), jb, jnp.int32(3))
    tp1, to1, tm1 = tstep(tparams, init_adamw(tparams), tb, 3)
    assert isinstance(to1, AdamWState)
    _check(tp1, to1, tm1, jp1, jo1, jm1)
    # resume from the reference's state after step 3
    rp = bridge.params_from_jax(jax.tree.map(np.asarray, jp1))
    ro = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jo1))
    jp2, jo2, jm2 = jstep(jp1, jo1, jb, jnp.int32(4))
    tp2, to2, tm2 = tstep(rp, ro, tb, 4)
    _check(tp2, to2, tm2, jp2, jo2, jm2)
