"""``loss_fn`` and every gradient against ``jax.value_and_grad`` on the
smoke configs of the MoE (the dropped fraction as the compiled form rounds
it) and recurrent families: loss within 1e-5, gradients within rtol 1e-4 /
atol 1e-6, except xlstm-1.3b at atol 1e-4: its gradients reach 5.6 (the
embedding's, ~25x the largest of the other archs'), and 1e-4 is 2e-5 of
that (``torch_grad_check``)."""
import pytest

from torch_grad_check import GRAD_TOL, check_loss_and_grads

ARCHS = {"qwen3-moe-30b-a3b": GRAD_TOL, "mixtral-8x7b": GRAD_TOL,
         "deepseek-v3-mla": GRAD_TOL, "recurrentgemma-9b": GRAD_TOL,
         "xlstm-1.3b": dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, ARCHS[arch])
