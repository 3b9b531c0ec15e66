"""The check that decides ``correct``, driven through a whole cell run at a
CPU size (the look for a card skipped), with the timed path broken
underneath: each fault a decode cell can have makes ``correct`` false, and
the unbroken program makes it true."""
import pytest
import torch

import bench_smoke_cases as S
from bench_smoke_cases import one_thread  # noqa: F401  (autouse)
from harness import check, offline_decode

CPU = torch.device("cpu")
CELLS = [(S.MOE_CONF, "dsv3.decode_32k"), (S.DENSE_CONF, "mla7b.decode_32k")]


def _run(conf, name, seed=2**31 + 11):
    wl = S.workload(name)
    return offline_decode.run(conf, wl, seed, 0.0, False, CPU, t_start=0.0, readers={})


def _state_unchanged(monkeypatch):
    """The decode step appends nothing to the pool and keeps seq_lens."""
    from repro_torch.models import transformer as T
    monkeypatch.setattr(T, "paged_mla_append", lambda pool, *a, **k: pool)


def _half_batch(monkeypatch):
    """Half of the rows are left out of each decode step and take the other
    half's logits: the second half on one step, the first on the next, so
    that every row is hit wherever the rows checked sit."""
    from repro_torch.models import transformer as T
    real = T.decode_step
    calls = [0]

    def half(params, cfg, token, state, pos, active=None):
        logits, new = real(params, cfg, token, state, pos, active)
        h = logits.shape[0] // 2
        calls[0] += 1
        kept = logits[:h] if calls[0] % 2 else logits[h:2 * h]
        return torch.cat([kept, kept, logits[2 * h:]])[:logits.shape[0]], new
    monkeypatch.setattr(T, "decode_step", half)


def _token_altered(monkeypatch):
    """Row 0's token is changed where it is sampled."""
    from repro_torch.launch import steps as ST
    real = ST.sample_logits

    def altered(logits, *a, **k):
        tok = real(logits, *a, **k).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(ST, "sample_logits", altered)


@pytest.mark.parametrize("conf,name", CELLS)
def test_unbroken_program_is_correct(conf, name):
    out = _run(conf, name)
    assert out.correct, out.compared


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
@pytest.mark.parametrize("conf,name", CELLS)
def test_fault_makes_correct_false(conf, name, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(conf, name)
    assert not out.correct, out.compared


def test_excess_is_zero_for_greedy_tokens_only():
    """A greedy token of logits that round away from the reference's reads
    exactly 0, even where the rounding flips the best token; a token
    altered after its logits reads above 0."""
    g = torch.Generator().manual_seed(5)
    ref = torch.randn(64, 50, generator=g) * 4
    ref[0, :2] = torch.tensor([30.0, 29.9999])               # a near-tie
    prog = ref + torch.randn(64, 50, generator=g) * 1e-3
    prog[0, :2] = torch.tensor([29.9998, 30.0001])            # the program takes the other
    served = prog.argmax(-1)
    assert int(served[0]) == 1
    assert float(check.excess(ref, prog, served).max()) == 0.0
    altered = served.clone()
    altered[3] = ref[3].argmin()
    assert float(check.excess(ref, prog, altered)[3]) > 1.0
