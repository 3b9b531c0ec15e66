"""``loss_fn`` (masked next-token cross entropy + the MoE dropped fraction)
and its gradient with respect to every parameter against
``jax.value_and_grad`` on the smoke configs of the attention families
(dense GQA, MLA, and the encoder families with a nonzero ``xgate``): loss
within 1e-5, every gradient within rtol 1e-4 / atol 1e-6
(``torch_grad_check``). The MoE and recurrent families are in
``test_torch_loss_grad_moe.py``. ``remat`` (each superblock under
``torch.utils.checkpoint``) changes no bit of the loss or the gradients."""
import pytest
import torch

from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.optim.adamw import tree_leaves
from torch_grad_check import batch, check_loss_and_grads, jax_model, port_value_and_grad

ARCHS = ("llama-3.2-vision-90b", "llama3.2-3b", "gemma3-27b", "qwen2.5-3b", "granite-3-2b",
         "whisper-base", "mla-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_remat_changes_no_bit(arch):
    """Vision's superblock is its 5 layers; whisper's superblocks are its
    'dec' layers (the encoder runs unchecked, as in the reference)."""
    jcfg, _, tparams = jax_model(arch)
    toks, labels, aux = batch(jcfg)
    cfg = t_smoke(arch)
    l1, _, g1 = port_value_and_grad(tparams, cfg, toks, labels, aux, remat=True)
    l0, _, g0 = port_value_and_grad(tparams, cfg, toks, labels, aux, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
