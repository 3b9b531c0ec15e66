"""Shared by the loss / gradient tests (``test_torch_loss_grad*.py``): the
port's ``loss_fn`` value and every gradient against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` (jitted, no mesh)
on one smoke config, with the same bridged weights (every ``xgate`` 0.5:
at its initial zero a cross layer's path would not show), tokens and
labels (the last three of row 0 masked with -1) and, for the encoder
families, aux embeddings — all numpy-seeded."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def set_xgate(jparams, value=0.5):
    def slot(p):
        return dict(p, xgate=jnp.full_like(p["xgate"], value)) if "xgate" in p else p
    return dict(jparams, scanned=[slot(p) for p in jparams.get("scanned", [])],
                tail=[slot(p) for p in jparams["tail"]])


def batch(cfg, seed=0, b=2, s=12):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, -3:] = -1
    aux = rng.standard_normal((b, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32) \
        if cfg.n_aux_tokens else None
    return toks, labels, aux


def port_value_and_grad(params, cfg, toks, labels, aux, remat=True):
    """(loss, metrics, gradient tree) of the port's ``loss_fn``."""
    live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, metrics = TT.loss_fn(tree_unflatten(params, iter(live)), cfg, torch.from_numpy(toks),
                               torch.from_numpy(labels),
                               None if aux is None else torch.from_numpy(aux), remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
    return loss.detach(), metrics, tree_unflatten(params, iter(grads))


def jax_model(arch):
    """(reference config, reference parameters with xgate 0.5, the port's
    bridged parameters) of ``arch``'s smoke config."""
    jcfg = j_smoke(arch)
    jparams = set_xgate(JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams))


def check_loss_and_grads(arch, grad_tol=GRAD_TOL):
    jcfg, jparams, tparams = jax_model(arch)
    toks, labels, aux = batch(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, t, lab, a: JT.loss_fn(p, jcfg, t, lab, a),
                                    has_aux=True))
    (j_loss, j_metrics), j_grads = fn(jparams, jnp.asarray(toks), jnp.asarray(labels),
                                      None if aux is None else jnp.asarray(aux))
    loss, metrics, grads = port_value_and_grad(tparams, t_smoke(arch), toks, labels, aux)
    np.testing.assert_allclose(float(loss), float(j_loss), **LOSS_TOL)
    assert float(metrics["ce"].detach()) == float(loss)
    np.testing.assert_allclose(float(metrics["moe_dropped"]), float(j_metrics["moe_dropped"]),
                               rtol=0, atol=1e-7)
    want = flatten(bridge.params_from_jax(jax.tree.map(np.asarray, j_grads)))
    got = flatten(grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path, **grad_tol)
