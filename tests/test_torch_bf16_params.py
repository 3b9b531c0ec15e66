"""Every smoke config at bfloat16 weights (the dry run's ``param_dtype``):
the port's train step, prefill and first decode step against the
reference's at bfloat16 on the same bridged weights (every ``xgate`` 0.5),
tokens and aux embeddings.

Mixed float32 / bfloat16 operands follow JAX's promotion
(``layers.promoted``): whisper's encoder and the cross layers read float32
aux rows against bfloat16 weights, the RG-LRU gates a float32 ``u``.

Tolerance. XLA and torch round bfloat16 dots at different points, so the
two packages at bfloat16 differ by about as much as bfloat16 moves either
of them. The test measures that move on each quantity,
``rnd = max |ref_bf16 - port_f32|`` (the port at float32 on the same
weights upcast, which the float32 tests hold to the reference within
1e-5), and requires ``max |port_bf16 - ref_bf16| <= 2 rnd + 2^-9 max
|ref_bf16|``: twice the measured rounding, plus half a bfloat16 ulp of the
largest value (which covers a quantity bfloat16 happens to move little,
e.g. llama3.2-3b's loss: rnd 1.4e-6). Measured on the CPU, the largest
ratio err / rnd was 2.6 (whisper-base's loss; its floor term is 1.1e-2)
and every logit error was below 2 rnd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import init_adamw, tree_leaves, tree_unflatten
from torch_grad_check import batch, set_xgate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S, CAP = 2, 12, 32
HALF_ULP = 2.0 ** -9


def _port(params, cfg, toks, labels, aux, first, pos):
    """(train-step loss, prefill logits, decode logits) of the port."""
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    ta = None if aux is None else torch.from_numpy(aux)
    if ta is not None:
        tb["aux_embed"] = ta
    _, _, m = TS.make_train_step(cfg)(params, init_adamw(params), tb, 0)
    st = TT.init_decode_state(cfg, B, CAP)
    l0, st = TT.prefill(params, cfg, torch.from_numpy(toks), st, ta)
    l1, _ = TT.decode_step(params, cfg, torch.from_numpy(first), st, torch.from_numpy(pos))
    return (np.float32(m["loss"]), l0.float().numpy(), l1.float().numpy())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_weights_train_prefill_decode_match_reference(arch):
    jcfg = j_smoke(arch)
    jp = set_xgate(JT.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tp))
    tp32 = tree_unflatten(tp, iter([x.float() for x in tree_leaves(tp)]))
    toks, labels, aux = batch(jcfg, b=B, s=S)
    ja = None if aux is None else jnp.asarray(aux)

    j_loss = jax.jit(lambda p, t, lab, a: JT.loss_fn(p, jcfg, t, lab, a)[0])(
        jp, toks, labels, ja)
    st = JT.init_decode_state(jcfg, B, CAP)
    j_l0, st = jax.jit(JS.make_prefill_step(jcfg))(jp, toks, st, *(() if ja is None else (ja,)))
    first = np.array(jnp.argmax(j_l0, -1), np.int32)
    pos = np.full((B,), S, np.int32)
    j_l1, _ = jax.jit(JS.make_decode_step(jcfg))(jp, first, st, pos)
    ref = (np.float32(j_loss), np.asarray(j_l0, np.float32), np.asarray(j_l1, np.float32))

    cfg = t_smoke(arch)
    got = _port(tp, cfg, toks, labels, aux, first, pos)
    f32 = _port(tp32, cfg, toks, labels, aux, first, pos)
    for what, g, r, f in zip(("loss", "prefill logits", "decode logits"), got, ref, f32):
        assert np.all(np.isfinite(g)), (arch, what)
        err = float(np.max(np.abs(g - r)))
        rnd = float(np.max(np.abs(r - f)))
        assert rnd > 0, (arch, what, "bfloat16 weights changed nothing")
        tol = 2 * rnd + HALF_ULP * float(np.max(np.abs(r)))
        assert err <= tol, (arch, what, err, rnd, tol)
