"""Training launcher of the port (``repro/launch/train.py``) on one device:
the train loop with checkpoint / restart, preemption handling and straggler
detection. The reference's mesh, sharding and compressed all-reduce belong
to the multi-device slice and are not here.

On the CPU, a real multi-step run on a smoke config:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mla-7b --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt --ckpt-every 10

On the card (the default device), e.g. whisper-base at full size:

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base --steps 20 \\
        --batch 8 --seq 448
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (latest_checkpoint, load_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from repro_torch.runtime.straggler import StragglerConfig, StragglerDetector


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
               ckpt_every: int = 50, preemption: PreemptionHandler | None = None,
               seed: int = 0, log_every: int = 5, lr: float = 3e-4, device=None) -> dict:
    """Train ``cfg`` from seeded random weights on ``synth_batch`` for steps
    ``[start, steps)``, where ``start`` is the step of the latest checkpoint
    under ``ckpt_dir`` (0 without one). A checkpoint of (params, AdamW
    state) lands every ``ckpt_every`` steps, and at once when ``preemption``
    is requested, which also ends the loop (status ``"preempted"``).

    Returns ``{"status", "losses" (this run's steps), "final_step",
    "params", "flagged_stragglers", "step_s"}``; ``step_s`` is each step's
    wall (synchronized on the card)."""
    device = resolve_device(device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          seed=seed, n_aux_tokens=cfg.n_aux_tokens, d_model=cfg.d_model)
    step_fn = ST.make_train_step(cfg, AdamWConfig(lr=lr), warmup_steps=max(2, steps // 10),
                                 total_steps=steps)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = T.init_model(gen, cfg, device=device)
    opt = init_adamw(params)
    start_step = 0
    if ckpt_dir:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            (params, opt), manifest = load_checkpoint(latest, (params, opt))
            start_step = manifest["step"]
            print(f"[train] resumed from {latest} at step {start_step}")

    detector = StragglerDetector(StragglerConfig(), n_hosts=1)
    losses, step_s = [], []
    status, final_step = "done", start_step
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch_data = {k: v.to(device) for k, v in synth_batch(data_cfg, step).items()}
        params, opt, metrics = step_fn(params, opt, batch_data, step)
        loss = float(metrics["loss"])
        _sync(device)
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_s.append(dt)
        detector.update(np.array([dt]))
        final_step = step + 1
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.2f}s)")
        should_ckpt = bool(ckpt_dir) and (step + 1) % ckpt_every == 0
        if preemption and preemption.requested:
            status = "preempted"
            should_ckpt = bool(ckpt_dir)
        if should_ckpt:
            path = save_checkpoint(ckpt_dir, step + 1, (params, opt),
                                   {"arch": cfg.name, "seed": seed, "data_cursor": step + 1})
            print(f"[train] checkpointed -> {path}")
        if status == "preempted":
            break
    return {"status": status, "losses": losses, "final_step": final_step,
            "params": params, "flagged_stragglers": detector.flagged, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mla-7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    handler = PreemptionHandler()
    try:
        out = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         preemption=handler, lr=args.lr, device=args.device)
    finally:
        handler.restore()
    if out["losses"]:
        print(f"[train] {out['status']} at step {out['final_step']}; "
              f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    else:
        print(f"[train] {out['status']} at step {out['final_step']}; no step left to run")
    return out


if __name__ == "__main__":
    main()
