"""Training launcher of the port (``repro/launch/train.py``): the sharded
train loop with checkpoint / restart, preemption handling and straggler
detection.

The loop runs on a mesh (``launch/mesh.py``; a world of one by default).
Parameters and AdamW state are DTensors placed by the reference's
``param_pspecs``, each step's global batch by ``batch_pspecs``, and the
mesh-independent ``make_train_step`` runs on them: DTensor's sharding
propagation inserts the collectives, as the reference's jit with its
in / out shardings lets GSPMD insert them. The reference's docstring names a
compressed all-reduce that its loop never calls; the port has none either
(``optim/grad_compression.py`` holds its math).

On the CPU, a real multi-step run on a smoke config (a gloo world of one):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mla-7b --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt --ckpt-every 10

On the card (the default device; an NCCL world of one), e.g. whisper-base at
full size:

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base --steps 20 \\
        --batch 8 --seq 448

Under ``torchrun --nproc-per-node N`` the same command trains on an (N, 1)
mesh, every rank drawing the same global batch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (latest_checkpoint, load_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWConfig, init_adamw, tree_leaves, tree_map,
                                    tree_unflatten)
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from repro_torch.runtime.straggler import StragglerConfig, StragglerDetector


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_placed(tree, like):
    """``tree``'s DTensor leaves redistributed to the placements of the
    matching leaves of ``like`` (a no-op where they agree): a step's outputs
    put back into its inputs' layout, as the reference's ``out_specs``
    (train.py:62-64) pin them."""
    out = [x if tuple(x.placements) == tuple(w.placements)
           else x.redistribute(w.device_mesh, w.placements)
           for x, w in zip(tree_leaves(tree), tree_leaves(like))]
    return tree_unflatten(tree, iter(out))


def sharded_step(step_fn, mesh):
    """``step_fn`` (``make_train_step``'s) on DTensors placed over ``mesh``:
    plain tensors the step makes (positions, masks, the lr) count as
    replicated (``implicit_replication``), every einsum runs on the local
    shards (``placement.local_einsum``), the new parameters and AdamW
    state come back in their inputs' placements, and every metric is a plain
    tensor, the same on every rank (the reference's ``P()`` out specs)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def step(params, opt, batch, i):
        with implicit_replication():
            new_p, new_o, metrics = step_fn(params, opt, batch, i)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return as_placed(new_p, params), as_placed(new_o, opt), metrics

    return step


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
               ckpt_every: int = 50, mesh=None, preemption: PreemptionHandler | None = None,
               seed: int = 0, log_every: int = 5, lr: float = 3e-4, device=None) -> dict:
    """Train ``cfg`` from seeded random weights on ``synth_batch`` for steps
    ``[start, steps)``, where ``start`` is the step of the latest checkpoint
    under ``ckpt_dir`` (0 without one), on ``mesh`` (default
    ``make_host_mesh(1, device)``: every rank of the world on 'data'). A
    checkpoint of (params, AdamW state) lands every ``ckpt_every`` steps,
    and at once when ``preemption`` is requested, which also ends the loop
    (status ``"preempted"``); it is written by rank 0 and loads on any mesh.
    A world this call starts is destroyed when it returns.

    Returns ``{"status", "losses" (this run's steps), "grad_norms",
    "final_step", "params", "flagged_stragglers", "step_s"}``: ``params``
    are DTensors on ``mesh``, or full tensors when the call started its own
    world; ``step_s`` is each step's wall (synchronized on the card)."""
    device = resolve_device(device)
    started = mesh is None and not dist.is_initialized()
    try:
        out = _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every,
                     mesh or make_host_mesh(1, device), preemption, seed, log_every, lr,
                     device)
        if started:
            out["params"] = tree_map(lambda x: x.full_tensor(), out["params"])
        return out
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every, mesh, preemption, seed, log_every,
           lr, device) -> dict:
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          seed=seed, n_aux_tokens=cfg.n_aux_tokens, d_model=cfg.d_model)
    step_fn = sharded_step(ST.make_train_step(cfg, AdamWConfig(lr=lr),
                                              warmup_steps=max(2, steps // 10),
                                              total_steps=steps), mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = T.init_model(gen, cfg, device=device)
    opt = init_adamw(params)
    shardings = (SH.to_named(SH.param_pspecs(params, mesh), mesh),
                 SH.to_named(SH.param_pspecs(opt, mesh), mesh))
    start_step = 0
    latest = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if latest:
        (params, opt), manifest = load_checkpoint(latest, (params, opt), shardings)
        start_step = manifest["step"]
        print(f"[train] resumed from {latest} at step {start_step}")
    else:
        params, opt = SH.place(params, shardings[0]), SH.place(opt, shardings[1])
    batch_named = SH.to_named(SH.batch_pspecs(synth_batch(data_cfg, 0), mesh), mesh)

    detector = StragglerDetector(StragglerConfig(), n_hosts=1)
    losses, gnorms, step_s = [], [], []
    status, final_step = "done", start_step
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch_data = SH.place({k: v.to(device) for k, v in synth_batch(data_cfg, step).items()},
                              batch_named)
        params, opt, metrics = step_fn(params, opt, batch_data, step)
        loss = float(metrics["loss"])
        _sync(device)
        dt = time.perf_counter() - t0
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(dt)
        detector.update(np.array([dt]))
        final_step = step + 1
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f} ({dt:.2f}s)")
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
    return {"status": status, "losses": losses, "grad_norms": gnorms,
            "final_step": final_step, "params": params,
            "flagged_stragglers": detector.flagged, "step_s": step_s}


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
