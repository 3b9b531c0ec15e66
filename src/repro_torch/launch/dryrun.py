"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): every
(arch x shape x mesh) cell's step on a modeled 256- or 512-rank mesh, with
no card and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mixtral-8x7b --shape decode_32k --mesh multipod --out out.json

The reference lowers and compiles each cell on 512 placeholder host devices
and reads XLA's memory analysis, cost analysis and the collectives of the
partitioned HLO. PyTorch has no HLO to read; here ``main`` starts the fake
process group (``torch.testing``'s ``FakeStore``: collectives return at
once, moving no data) as a world of 256 (``pod``) or 512 (``multipod``)
ranks, builds the production mesh over it, places the cell's inputs (``meta``
tensors from ``steps.input_specs``: shapes and dtypes, no storage) as
DTensors by the reference's own specs, and runs the step on them as rank 0:

* pass 1 runs the sharded step once under a dispatch mode that sorts every
  collective DTensor issues into the reference's five kinds and sums its
  output bytes per rank, and tracks the live storage of every tensor the
  step makes (the memory record);
* pass 2 counts the FLOPs of the unsharded step (``FlopCounterMode``), the
  reference's cost-exact global count.

Nothing is scanned in the port (its layers are a list, its flash blocks a
Python loop), so both passes see every layer at full depth: the reference's
cost-exact unrolling and its two-depth extrapolation of the collectives
(``_extrapolated_collectives``, there because a scanned body's collectives
are counted once) have nothing to do here.

Importing this module starts no process group and imports no private torch
module; ``main`` (and ``fake_world``) do.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref

import torch

from repro_torch.configs import get_config
from repro_torch.core import placement as PL
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import MESH_SIZES, make_production_mesh
from repro_torch.launch.sharding import P

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives DTensor issues -> the reference's kinds
_KIND_OF = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
COLLECTIVE_NOTE = (
    "output bytes per rank of the functional collectives DTensor issued on rank 0 "
    "(fake process group); DTensor has no collective-permute (reported 0), and on a "
    "'cpu' mesh it lowers all-to-all to all-gather + chunk")
ALIAS_NOTE = ("null: no buffer is donated; DTensor keeps no input/output alias "
              "table to read")


def fake_world(n_ranks: int) -> None:
    """Make the default process group a fake world of ``n_ranks`` (this
    process is rank 0), or check that the existing one has that size."""
    import torch.distributed as dist
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != n_ranks:
            raise RuntimeError(f"the dry run needs a world of {n_ranks} ranks; a default "
                               f"process group of {have} exists")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if type(t).__name__ == "DTensor" else t


def local_bytes(tree) -> int:
    """Sum over the tensor leaves of ``tree`` of this rank's shard bytes."""
    from repro_torch.checkpoint.checkpoint import flatten
    return sum(_nbytes(_local(t)) for _, t in flatten(tree))


def step_recorder():
    """A dispatch mode (built on first use: its base class and the fake
    tensor it skips live in private torch modules) that counts the
    functional collectives under it (output bytes per kind, and how many
    were issued inside a ``region()``, the body of a collective-free
    ``local_map`` region) and tracks the bytes of live storage: every
    tensor an op returns registers its storage, freed when the last tensor
    registered on it dies; ``peak`` is the most ever live."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class StepRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = dict.fromkeys(COLLECTIVES, 0)
            self.counts = dict.fromkeys(COLLECTIVES, 0)
            self.in_region = 0
            self.regions = 0            # region bodies entered
            self.region_counts = 0      # collectives issued inside one
            self.live = 0
            self.peak = 0
            self._refs: dict[int, list] = {}

        def hold(self, t: torch.Tensor) -> None:
            """Register ``t``'s storage as live (for as long as ``t`` is)."""
            st = t.untyped_storage()
            key = st._cdata
            ref = self._refs.get(key)
            if ref is None:
                ref = self._refs[key] = [0, st.nbytes()]
                self.live += ref[1]
                self.peak = max(self.peak, self.live)
            ref[0] += 1
            weakref.finalize(t, self._drop, key)

        def _drop(self, key: int) -> None:
            ref = self._refs.get(key)
            if ref is not None:
                ref[0] -= 1
                if ref[0] == 0:
                    self.live -= ref[1]
                    del self._refs[key]

        @contextlib.contextmanager
        def region(self):
            self.regions += 1
            self.in_region += 1
            try:
                yield
            finally:
                self.in_region -= 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **(kwargs or {}))
            if any(t is DTensor for t in types):
                # let DTensor run first: its local ops and collectives come
                # back through this mode
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if func.namespace == "_c10d_functional" and name in _KIND_OF:
                kind = _KIND_OF[name]
                self.counts[kind] += 1
                self.bytes[kind] += _nbytes(out)
                self.region_counts += bool(self.in_region)
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                # DTensor derives each op's global output shape by running
                # it on fake tensors: no rank holds those
                if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                    self.hold(t)
            return out

    return StepRecorder()


def _in_specs(cfg, kind, args, mesh, ws):
    """The reference's in specs of a cell (dryrun.py:91-116)."""
    if kind == "train":
        params, opt, batch, _ = args
        return (SH.param_pspecs(params, mesh), SH.param_pspecs(opt, mesh),
                SH.batch_pspecs(batch, mesh), P())
    params, tokens, state = args[:3]
    if kind == "prefill":
        ins = (SH.param_pspecs(params, mesh, weight_stationary=ws),
               SH.batch_pspecs({"t": tokens}, mesh)["t"], SH.state_pspecs(state, mesh, cfg))
        if cfg.n_aux_tokens:
            ins = ins + (SH.batch_pspecs({"a": args[3]}, mesh)["a"],)
        return ins
    dpa = SH.dp_axes_for(tokens.shape[0], mesh)
    return (SH.param_pspecs(params, mesh, weight_stationary=ws, attn_fallback="shard_dh"),
            P(dpa), SH.state_pspecs(state, mesh, cfg), P(dpa))


def _pin(cfg, kind, out, placed, mesh):
    """The step's outputs in the reference's out shardings: for the train
    step the new params and AdamW state in their inputs' placements and
    every metric replicated; else the logits P(dp, None) and the state by
    ``state_pspecs``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.train import as_placed
    if kind == "train":
        rep = [Replicate()] * mesh.ndim
        return (as_placed(out[0], placed[0]), as_placed(out[1], placed[1]),
                {k: v.redistribute(mesh, rep) if isinstance(v, DTensor) else v
                 for k, v in out[2].items()})
    dpa = SH.dp_axes_for(placed[1].shape[0], mesh)
    named = SH.to_named((P(dpa, None), SH.state_pspecs(out[1], mesh, cfg)), mesh)

    def to(path, t):
        n = SH._at(named, path)
        if not isinstance(t, DTensor) or tuple(t.placements) == n.placements:
            return t
        return t.redistribute(mesh, n.placements)
    return SH.map_with_path(to, out)


def _pass1(cfg, shape, mesh, remat, variant):
    """The sharded step once, recorded: (kind, record fields, rank 0's own
    FLOPs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import distributed_decode as DD
    from repro_torch.models import transformer as T
    kind, args = ST.input_specs(cfg, shape)
    step = ST.step_fn_for(cfg, kind, remat=remat)
    ws = variant.startswith("serve_ws") and kind in ("decode", "prefill")
    if variant.endswith(("_local", "_smap")) and kind == "decode":
        T.SHARD_CTX = {"mesh": mesh, "dp": SH.dp_axes_for(args[1].shape[0], mesh),
                       "use_shard_map": variant.endswith("_smap")}
    else:
        T.SHARD_CTX = None
    rec = step_recorder()
    PL.REPLICATED.clear()
    try:
        placed = SH.place(args, SH.to_named(_in_specs(cfg, kind, args, mesh, ws), mesh))
        arg_bytes = local_bytes(placed)
        t0 = time.time()
        with FlopCounterMode(display=False) as fc, rec, implicit_replication(), \
                DD.region_scope(rec.region):
            for t in _leaves(placed):
                rec.hold(_local(t))
            out = _pin(cfg, kind, step(*placed), placed, mesh)
        lower_s = time.time() - t0
    finally:
        T.SHARD_CTX = None
    return kind, {
        "lower_s": round(lower_s, 1), "compile_s": None,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
                   "temp_bytes": rec.peak - arg_bytes, "peak_bytes": rec.peak,
                   "alias_bytes": None, "alias_note": ALIAS_NOTE},
        "collectives": {"bytes": dict(rec.bytes), "counts": dict(rec.counts),
                        "total_bytes": sum(rec.bytes.values()),
                        "in_region": rec.region_counts, "regions": rec.regions,
                        "method": "direct-full-depth", "note": COLLECTIVE_NOTE},
        "replicated_ops": dict(PL.REPLICATED),
    }, int(fc.get_total_flops())


def _leaves(tree):
    from repro_torch.checkpoint.checkpoint import flatten
    return [t for _, t in flatten(tree)]


def global_flops(cfg, shape, remat=True) -> int:
    """FLOPs of the cell's step, unsharded (``FlopCounterMode`` over its
    ``meta`` inputs): matmuls, attention and convolutions, forward and
    backward, every layer."""
    from torch.utils.flop_counter import FlopCounterMode
    kind, args = ST.input_specs(cfg, shape)
    step = ST.step_fn_for(cfg, kind, remat=remat)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return int(fc.get_total_flops())


def run_cell(arch: str, shape: str, mesh_kind: str, remat: bool = True,
             extra: dict | None = None, cost_pass: bool = True,
             variant: str = "baseline") -> dict:
    """One cell's record (dryrun.py:119-190). ``variant``: 'baseline' (FSDP x
    TP everywhere) or 'serve_ws' (weight-stationary DP x TP for the serving
    kinds), either with '_local' / '_smap' for decode under ``SHARD_CTX``
    (the latter through the collective-free region). Needs the default
    process group to be a world of the mesh's size (``fake_world``)."""
    cfg = get_config(arch)
    if extra:
        cfg = cfg.scaled(**extra)
    ok, why = ST.shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "reason": why}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"), device_type="cpu")
    n_chips = mesh.size()
    kind, fields, rank_flops = _pass1(cfg, shape, mesh, remat, variant)
    result = {"arch": arch, "shape": shape, "mesh": mesh_kind, "kind": kind,
              "variant": variant, "status": "ok", "n_chips": n_chips,
              "lower_s": fields.pop("lower_s"), "compile_s": fields.pop("compile_s"),
              **fields,
              "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count(),
              "kv_fmt": cfg.kv_fmt}
    if cost_pass:
        t0 = time.time()
        fg = global_flops(cfg, shape, remat)
        result.update({"flops_global": fg, "flops": fg / n_chips,
                       "cost_pass": {"exact": True, "method": "flop-counter-global/chips",
                                     "seconds": round(time.time() - t0, 1)}})
    else:
        result.update({"flops": rank_flops,
                       "cost_pass": {"exact": False, "method": "flop-counter-rank0",
                                     "caveat": "rank 0's local FLOPs of the sharded step"}})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(ST.SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-cost-pass", action="store_true",
                    help="skip the unsharded FLOP pass (flops from rank 0's sharded step)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    fake_world(MESH_SIZES[args.mesh])
    res = run_cell(args.arch, args.shape, args.mesh, remat=not args.no_remat,
                   cost_pass=not args.no_cost_pass)
    print(json.dumps(res, indent=1, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
