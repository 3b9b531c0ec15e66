"""The recurrent blocks of the port (``models/rglru.py``, ``models/xlstm.py``)
against the JAX package's on the same bridged weights and inputs, at
tests/test_recurrent.py's sizes and tolerances: RG-LRU block and step (rtol
1e-4, atol 1e-5; the port scans sequentially where the reference runs an
associative scan), mLSTM (2e-3 / 2e-4), sLSTM (1e-5 / 1e-6); block equal to
the steps inside the port; the RG-LRU state carried across chunks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro.models import xlstm as JX
from repro_torch import bridge
from repro_torch.models import rglru as TR
from repro_torch.models import xlstm as TX

RGLRU_TOL = dict(rtol=1e-4, atol=1e-5)
MLSTM_TOL = dict(rtol=2e-3, atol=2e-4)
SLSTM_TOL = dict(rtol=1e-5, atol=1e-6)


def _port(kind, jparams):
    return kind(**bridge.to_torch(jax.tree.map(np.asarray, jparams)))


def _x(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _steps(step, params, x, st):
    ys = []
    for t in range(x.shape[1]):
        y, st = step(params, x[:, t], st)
        ys.append(y)
    return torch.stack(ys, dim=1), st


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_rglru_block_and_step_match_jax():
    d, B, S = 16, 2, 12
    jp = JR.init_rglru_params(jax.random.PRNGKey(0), d, d)
    tp = _port(TR.RGLRUParams, jp)
    x = _x(1, (B, S, d))
    y_j, st_j = jax.jit(JR.rglru_block)(jp, x)
    y_t, st_t = TR.rglru_block(tp, torch.from_numpy(x))
    _close(y_t, y_j, RGLRU_TOL)
    _close(st_t.h, st_j.h, RGLRU_TOL)
    _close(st_t.conv, st_j.conv, RGLRU_TOL)
    # one decode step from the block's state, on both sides
    x_t = _x(2, (B, d))
    y1_j, s1_j = jax.jit(JR.rglru_step)(jp, x_t, st_j)
    y1_t, s1_t = TR.rglru_step(tp, torch.from_numpy(x_t), st_t)
    _close(y1_t, y1_j, RGLRU_TOL)
    _close(s1_t.h, s1_j.h, RGLRU_TOL)
    # the port's block equals its steps
    y_s, st_s = _steps(TR.rglru_step, tp, torch.from_numpy(x), TR.init_rglru_state(B, d))
    np.testing.assert_allclose(y_t.numpy(), y_s.numpy(), **RGLRU_TOL)
    np.testing.assert_allclose(st_t.h.numpy(), st_s.h.numpy(), **RGLRU_TOL)


def test_rglru_state_carries_across_chunks():
    d, B = 8, 1
    jp = JR.init_rglru_params(jax.random.PRNGKey(2), d, d)
    tp = _port(TR.RGLRUParams, jp)
    x = torch.from_numpy(_x(3, (B, 10, d)))
    y_full, _ = TR.rglru_block(tp, x)
    _, st = TR.rglru_block(tp, x[:, :6])
    y2, _ = TR.rglru_block(tp, x[:, 6:], st)
    np.testing.assert_allclose(y_full[:, 6:].numpy(), y2.numpy(), **RGLRU_TOL)
    j2, _ = JR.rglru_block(jp, jnp.asarray(x[:, 6:].numpy()),
                           JR.rglru_block(jp, jnp.asarray(x[:, :6].numpy()))[1])
    _close(y2, j2, RGLRU_TOL)


def test_mlstm_block_and_step_match_jax():
    d, B, S, H, dh = 16, 2, 10, 2, 8
    jp = JX.init_mlstm_params(jax.random.PRNGKey(4), d, H, dh)
    tp = _port(TX.MLSTMParams, jp)
    x = _x(5, (B, S, d))
    y_j, st_j = jax.jit(JX.mlstm_block)(jp, x)
    y_t, st_t = TX.mlstm_block(tp, torch.from_numpy(x))
    _close(y_t, y_j, MLSTM_TOL)
    for f in ("c", "n", "m"):
        _close(getattr(st_t, f), getattr(st_j, f), MLSTM_TOL)
    y_js, st_js = jax.jit(lambda p, x: _jax_steps(JX.mlstm_step, p, x,
                                                  JX.init_mlstm_state(B, H, dh)))(jp, x)
    y_s, st_s = _steps(TX.mlstm_step, tp, torch.from_numpy(x), TX.init_mlstm_state(B, H, dh))
    _close(y_s, y_js, MLSTM_TOL)
    _close(st_s.c, st_js.c, MLSTM_TOL)
    np.testing.assert_allclose(y_t.numpy(), y_s.numpy(), **MLSTM_TOL)
    np.testing.assert_allclose(st_t.c.numpy(), st_s.c.numpy(), **MLSTM_TOL)


def test_slstm_block_and_step_match_jax():
    d, B, S, H, dh = 12, 2, 7, 2, 6
    jp = JX.init_slstm_params(jax.random.PRNGKey(6), d, H, dh)
    tp = _port(TX.SLSTMParams, jp)
    x = _x(7, (B, S, d))
    y_j, st_j = jax.jit(JX.slstm_block)(jp, x)
    y_t, st_t = TX.slstm_block(tp, torch.from_numpy(x))
    _close(y_t, y_j, SLSTM_TOL)
    for f in ("c", "n", "h", "m"):
        _close(getattr(st_t, f), getattr(st_j, f), SLSTM_TOL)
    y_s, _ = _steps(TX.slstm_step, tp, torch.from_numpy(x), TX.init_slstm_state(B, H, dh))
    np.testing.assert_allclose(y_t.numpy(), y_s.numpy(), **SLSTM_TOL)


def _jax_steps(step, params, x, st):
    ys = []
    for t in range(x.shape[1]):
        y, st = step(params, x[:, t], st)
        ys.append(y)
    return jnp.stack(ys, axis=1), st


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_freeze_inactive_keeps_finished_rows(kind):
    """``_freeze_inactive`` (transformer.py:434): a decode step with
    ``active`` False on a row leaves that row's state as it was, the other
    rows as the ungated step leaves them."""
    from repro_torch.models import transformer as T
    d, B, H, dh = 8, 3, 2, 4
    gen = torch.Generator().manual_seed(0)
    if kind == "rglru":
        p, st = TR.init_rglru_params(gen, d, d), TR.init_rglru_state(B, d)
    elif kind == "mlstm":
        p, st = TX.init_mlstm_params(gen, d, H, dh), TX.init_mlstm_state(B, H, dh)
    else:
        p, st = TX.init_slstm_params(gen, d, H, dh), TX.init_slstm_state(B, H, dh)
    x = torch.randn(B, d, generator=gen)
    _, st = T._STEPS[kind](p, x, st)
    _, new = T._STEPS[kind](p, torch.randn(B, d, generator=gen), st)
    active = torch.tensor([True, False, True])
    frozen = T._freeze_inactive(active, new, st)
    assert type(frozen) is type(st)
    for f, o, n in zip(frozen, st, new):
        assert torch.equal(f[1], o[1]) and torch.equal(f[0], n[0]) and torch.equal(f[2], n[2])
