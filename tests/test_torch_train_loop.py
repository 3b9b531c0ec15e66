"""The port's training loop and data pipeline on the CPU, held to the
assertions of the reference's tests of them — which fail under this
container's jax (``train_loop``'s sharded jit; ROADMAP queue 3), so the
port is held to what they assert, not to a JAX run:

  * tests/test_data.py, assertion for assertion (the draws are the port's
    own: a ``torch.Generator`` per (seed, step), not JAX's threefry bits),
    plus the encoder families' aux embeddings;
  * tests/test_train_loop.py::test_loss_decreases;
  * tests/test_checkpoint.py::test_train_resume_continues;
  * tests/test_fault_tolerance.py::test_preemption_checkpoints_and_exits and
    ::test_straggler_detector_flags_slow_host;
  * ``python -m repro_torch.launch.train --smoke --device cpu``, and a
    whisper-base run with its aux embeddings."""
import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import latest_checkpoint, load_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator, host_slice, synth_batch
from repro_torch.launch import train as TR
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState, init_adamw
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from repro_torch.runtime.straggler import StragglerConfig, StragglerDetector
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=7)


# tests/test_data.py
def test_deterministic_per_step():
    a = synth_batch(CFG, 3)
    b = synth_batch(CFG, 3)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
    c = synth_batch(CFG, 4)
    assert not np.array_equal(a["tokens"].numpy(), c["tokens"].numpy())


def test_host_slices_partition_global_batch():
    full = synth_batch(CFG, 0)
    parts = [host_slice(CFG, 0, h, 4) for h in range(4)]
    glued = np.concatenate([p["tokens"].numpy() for p in parts])
    np.testing.assert_array_equal(glued, full["tokens"].numpy())


def test_iterator_resumes():
    it = batch_iterator(CFG, start_step=5)
    step, batch = next(it)
    assert step == 5
    np.testing.assert_array_equal(batch["tokens"].numpy(), synth_batch(CFG, 5)["tokens"].numpy())


def test_labels_are_shifted_tokens():
    b = synth_batch(CFG, 1)
    assert b["tokens"].shape == b["labels"].shape == (8, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(), b["labels"][:, :-1].numpy())


def test_aux_embed_zipf_and_repeats():
    """The encoder families get [B, n_aux, d] float32 embeddings, the same
    per (seed, step); tokens are Zipf-heavy (id 0 the most common) and some
    rows repeat their first half."""
    cfg = DataConfig(vocab_size=512, seq_len=63, global_batch=16, seed=3, n_aux_tokens=5,
                     d_model=8)
    a, b = synth_batch(cfg, 2), synth_batch(cfg, 2)
    assert a["aux_embed"].shape == (16, 5, 8) and a["aux_embed"].dtype == torch.float32
    assert torch.equal(a["aux_embed"], b["aux_embed"])
    assert "aux_embed" not in synth_batch(CFG, 0)
    assert a["tokens"].dtype == torch.int32
    counts = torch.bincount(a["tokens"].flatten().long(), minlength=512)
    assert int(counts.argmax()) == 0
    seq = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)
    rep = (seq[:, 32:] == seq[:, :32]).all(dim=1)
    assert 0 < int(rep.sum()) < 16


# tests/test_train_loop.py::test_loss_decreases
def test_loss_decreases():
    cfg = get_smoke_config("llama3.2-3b")
    out = train_loop(cfg, steps=25, batch=8, seq=32, ckpt_dir=None, lr=3e-3, log_every=100,
                     device="cpu")
    first = np.mean(out["losses"][:3])
    last = np.mean(out["losses"][-3:])
    assert out["status"] == "done"
    assert last < first - 0.1, (first, last)


# tests/test_checkpoint.py::test_train_resume_continues
def test_train_resume_continues(tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    out1 = train_loop(cfg, steps=6, batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=3,
                      log_every=100, device="cpu")
    assert latest_checkpoint(str(tmp_path)) is not None
    out2 = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=100,
                      log_every=100, device="cpu")
    assert out2["final_step"] == 10
    assert len(out2["losses"]) == 4          # 6..9 only
    assert out1["final_step"] == 6


class _PreemptAfter:
    """``requested`` turns True at the loop's ``n``-th check (after step n)."""

    def __init__(self, n):
        self.n, self.count = n, 0

    @property
    def requested(self):
        self.count += 1
        return self.count >= self.n


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """A 10-step run preempted after step 6 and restarted from its
    checkpoint gives the losses and weights of one unbroken 10-step run
    (the batch is a function of (seed, step); the optimizer state and its
    step count are restored)."""
    cfg = get_smoke_config("qwen2.5-3b")
    full = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=None, log_every=100,
                      device="cpu")
    cut = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=100,
                     preemption=_PreemptAfter(6), log_every=100, device="cpu")
    assert cut["status"] == "preempted" and cut["final_step"] == 6
    assert cut["losses"] == full["losses"][:6]
    rest = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=100,
                      log_every=100, device="cpu")
    assert rest["losses"] == full["losses"][6:]
    assert torch.equal(rest["params"]["embed"], full["params"]["embed"])
    like = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    (_, opt), manifest = load_checkpoint(latest_checkpoint(str(tmp_path)),
                                         (like, init_adamw(like)))
    assert isinstance(opt, AdamWState) and int(opt.step) == 6 == manifest["data_cursor"]


# tests/test_fault_tolerance.py::test_preemption_checkpoints_and_exits
def test_preemption_checkpoints_and_exits(tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    PreemptionHandler(install=False)

    class TripWire:
        def __init__(self):
            self.count = 0

        @property
        def requested(self):
            self.count += 1
            return self.count > 2

    out = train_loop(cfg, steps=50, batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=1000,
                     preemption=TripWire(), log_every=100, device="cpu")
    assert out["status"] == "preempted"
    assert out["final_step"] < 50
    assert latest_checkpoint(str(tmp_path)) is not None


# tests/test_fault_tolerance.py::test_straggler_detector_flags_slow_host
def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(StragglerConfig(warmup_steps=2, threshold=1.5), 8)
    times = np.ones(8)
    for step in range(10):
        t = times.copy()
        if step >= 5:
            t[3] = 4.0
        flagged = det.update(t)
    assert 3 in flagged
    assert all(h == 3 for _, h in det.flagged)


def test_train_main_cpu(capsys, tmp_path):
    out = TR.main(["--arch", "whisper-base", "--smoke", "--device", "cpu", "--steps", "4",
                   "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2"])
    text = capsys.readouterr().out
    assert "[train] done at step 4" in text and out["final_step"] == 4
    assert all(np.isfinite(out["losses"])) and len(out["step_s"]) == 4
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004")
