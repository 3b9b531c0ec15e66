"""The rank function of the spawned gloo world that the multi-rank tests of
``test_torch_distributed_decode.py`` share, and the inputs both sides draw.

Every rank runs ``run``: on each mesh of ``MESHES`` (over a world of
``WORLD`` ranks, ``("data", "model")``) the decode region and the append
(under ``CommDebugMode``), ``to_named``'s local shard shapes and
``load_checkpoint(shardings=)``; then ``serve.generate`` on the smoke
mla-7b with the ``shard-map`` backend over ``make_host_mesh(1)``; then
``train_loop`` on each of ``TRAIN_MESHES`` for ``TRAIN_ARCHS``, a preempted
run on the first mesh resumed on the second, one step's collectives, and a
checkpoint saved from DTensors. It saves what it saw to
``<out_dir>/rank<r>.pt``; the test process compares. Imports neither JAX
nor the JAX package (``jax`` is blocked in the rank)."""
import dataclasses
import os
import sys

import numpy as np
import torch

WORLD = 4
MESHES = ((2, 2), (4, 1), (1, 4))
REGION_CASES = (("fp8_e4m3", 1), ("fp8_e4m3", 4), ("int8", 1), ("int8", 4))
# region / append shapes: B and H divide every mesh axis above
B, H, D_C, D_R, N, S, PAGE, SINK = 4, 8, 32, 16, 64, 50, 32, 3
SCALE = 0.1
SERVE_B, SERVE_S, SERVE_GEN = 4, 12, 6
TRAIN_MESHES = ((2, 2), (4, 1))
TRAIN_ARCHS = ("mla-7b", "llama3.2-3b")
TRAIN = dict(steps=4, batch=4, seq=16, log_every=100)
PREEMPT_AT = 2


class PreemptAfter:
    """``requested`` turns True at the train loop's ``n``-th check (after
    step ``n``)."""

    def __init__(self, n: int):
        self.n, self.count = n, 0

    @property
    def requested(self) -> bool:
        self.count += 1
        return self.count >= self.n


def region_inputs(fmt: str, seed: int = 0, sink: int = 0):
    """(query (q_c8, q_r, sigma_q), cache, cache config), numpy-seeded."""
    from repro_torch.core.kvcache import CacheConfig, init_mla_cache, mla_prefill
    from repro_torch.kernels.mla_decode import ref
    rng = np.random.RandomState(seed)
    cfg = CacheConfig(fmt=fmt, page_size=PAGE, sink_tokens=sink)
    c_kv = torch.from_numpy(rng.standard_normal((B, S, D_C)).astype(np.float32) * 2)
    k_r = torch.from_numpy(rng.standard_normal((B, S, D_R)).astype(np.float32) * 20)
    cache = mla_prefill(init_mla_cache(cfg, B, N, D_C, D_R), cfg, c_kv, k_r)
    # the rows grow apart so every split and row ends somewhere else
    cache = cache._replace(seq_lens=torch.tensor([S, S - 7, 33, S - 1], dtype=torch.int32))
    q = torch.from_numpy(rng.standard_normal((B, H, D_C)).astype(np.float32))
    q_r = torch.from_numpy(rng.standard_normal((B, H, D_R)).astype(np.float32) * 3)
    return ref.prepare_q(q, q_r, fmt), cache, cfg


def append_inputs(seed: int = 1):
    """(c_kv, k_r, active) for one appended token per row."""
    rng = np.random.RandomState(seed)
    c_kv = torch.from_numpy(rng.standard_normal((B, D_C)).astype(np.float32))
    k_r = torch.from_numpy(rng.standard_normal((B, D_R)).astype(np.float32) * 3)
    return c_kv, k_r, torch.tensor([True, False, True, False])


def serve_setup():
    """(config, weights, prompts) of the smoke mla-7b serve run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("mla-7b")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_model(gen, cfg, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg.vocab_size, (SERVE_B, SERVE_S))
    return cfg, params, torch.from_numpy(prompts)


def ckpt_tree():
    """The tree saved to the checkpoint the ranks load back."""
    return serve_setup()[1]


def _clone(cache):
    return type(cache)(*(None if t is None else t.clone() for t in cache))


def _gather_bits(t):
    """``t.full_tensor()`` gathered as bytes (gloo has no fp8), viewed back
    as its dtype. ``t`` is sharded on its first dimension only."""
    from torch.distributed.tensor import DTensor
    local = t.to_local().view(torch.uint8)
    shape = (*t.shape[:-1], t.shape[-1] * t.element_size())
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False,
                              shape=shape, stride=local.stride()).full_tensor().view(t.dtype)


def _mesh_checks(mesh, shape, ckpt_dir, out):
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint.checkpoint import flatten, latest_checkpoint, load_checkpoint
    from repro_torch.core import distributed_decode as DD
    from repro_torch.launch import sharding as SH

    for fmt, splits in REGION_CASES:
        (q_c8, q_r, sq), cache, _ = region_inputs(fmt, sink=SINK if splits == 4 else 0)
        with CommDebugMode() as comm:
            o = DD.mla_decode_shard_map(mesh, "data", q_c8, q_r, sq, cache,
                                        softmax_scale=SCALE, block_n=16, fmt=fmt,
                                        num_splits=splits)
        out[("region", shape, fmt, splits)] = {
            "o": o.full_tensor(), "collectives": comm.get_total_counts(),
            "local": tuple(o.to_local().shape)}

    c_kv, k_r, active = append_inputs()
    for gated in (False, True):
        _, cache, ccfg = region_inputs("fp8_e4m3", sink=SINK)
        cache = _clone(cache)
        with CommDebugMode() as comm:
            got = DD.mla_append_shard_map(mesh, "data", cache, ccfg, c_kv, k_r,
                                          active=active if gated else None)
        out[("append", shape, gated)] = {
            "cache": [_gather_bits(t) for t in got], "collectives": comm.get_total_counts()}

    params = ckpt_tree()
    named = SH.to_named(SH.param_pspecs(params, mesh), mesh)
    placed = SH.place(params, named)
    out[("placed", shape)] = [(p, tuple(t.to_local().shape), tuple(t.placements))
                              for p, t in flatten(placed)]
    loaded, _ = load_checkpoint(latest_checkpoint(ckpt_dir), params, named)
    got = flatten(loaded)
    want = []
    SH.map_with_path(lambda _, n: want.append(n.placements), named, leaf=SH.NamedPlacements)
    out[("ckpt", shape)] = {
        "placements_ok": all(tuple(t.placements) == w for (_, t), w in zip(got, want)),
        "equal": all(torch.equal(t.full_tensor(), s) for (_, t), (_, s)
                     in zip(got, flatten(params))),
        "leaves": len(got)}


def _train_checks(root: str, out: dict) -> None:
    """``train_loop`` on each mesh of ``TRAIN_MESHES``; a run preempted
    after step ``PREEMPT_AT`` on the first mesh, its checkpoint written by
    rank 0 alone, resumed on the second; the collectives of one sharded step;
    a checkpoint saved from the (4, 1) placement of ``ckpt_tree()``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import sharded_step, train_loop
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import init_adamw, tree_leaves

    meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
              for shape in TRAIN_MESHES}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        for shape, mesh in meshes.items():
            r = train_loop(cfg, ckpt_dir=None, mesh=mesh, device="cpu", **TRAIN)
            out[("train", arch, shape)] = {
                "losses": r["losses"], "grad_norms": r["grad_norms"],
                "params": [t.full_tensor() for t in tree_leaves(r["params"])]}

    writes = []
    savez = C.np.savez
    C.np.savez = lambda *a, **k: (writes.append(a[0]), savez(*a, **k))
    cfg = get_smoke_config(TRAIN_ARCHS[0])
    first, second = (meshes[s] for s in TRAIN_MESHES)
    ckpt = os.path.join(root, "train_ckpt")
    cut = train_loop(cfg, ckpt_dir=ckpt, ckpt_every=1000, mesh=first, device="cpu",
                     preemption=PreemptAfter(PREEMPT_AT), **TRAIN)
    published = sorted(os.listdir(ckpt))
    rest = train_loop(cfg, ckpt_dir=ckpt, ckpt_every=1000, mesh=second, device="cpu",
                      **TRAIN)
    C.np.savez = savez
    out["preempt"] = {"status": cut["status"], "final_step": cut["final_step"],
                      "writes": len(writes), "published": published,
                      "resumed_losses": rest["losses"], "resumed_final": rest["final_step"],
                      "params": [t.full_tensor() for t in tree_leaves(rest["params"])]}

    mesh = meshes[TRAIN_MESHES[0]]
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_model(gen, cfg, device="cpu")
    opt = init_adamw(params)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"], seed=0)
    batch = synth_batch(data, 0)
    placed = (SH.place(params, SH.to_named(SH.param_pspecs(params, mesh), mesh)),
              SH.place(opt, SH.to_named(SH.param_pspecs(opt, mesh), mesh)),
              SH.place(batch, SH.to_named(SH.batch_pspecs(batch, mesh), mesh)))
    step = sharded_step(ST.make_train_step(cfg), mesh)
    with CommDebugMode() as comm:
        step(*placed, 0)
    out["train_collectives"] = {str(k).split(".")[-1]: v
                                for k, v in comm.get_comm_counts().items()}

    tree = ckpt_tree()
    mesh = meshes[(4, 1)]
    C.save_checkpoint(os.path.join(root, "saved_on_4x1"), 1,
                      SH.place(tree, SH.to_named(SH.param_pspecs(tree, mesh), mesh)))


def run(rank: int, world: int, init_file: str, ckpt_dir: str, out_dir: str) -> None:
    sys.modules["jax"] = None                 # any `import jax` in the rank raises
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    out: dict = {}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        _mesh_checks(mesh, shape, ckpt_dir, out)

    cfg, params, prompts = serve_setup()
    mesh = make_host_mesh(1, "cpu")
    T.SHARD_CTX = {"mesh": mesh, "dp": "data", "use_shard_map": True}
    cfg = dataclasses.replace(cfg, decode_backend="shard-map")
    toks, _, logits = serve.generate(cfg, params, prompts, SERVE_GEN, return_logits=True)
    out["serve"] = {"mesh": tuple(mesh.shape), "tokens": toks, "logits": logits}
    state = T.init_decode_state(cfg, SERVE_B, 32, device="cpu")
    with CommDebugMode() as comm:
        T.decode_step(params, cfg, prompts[:, 0], state,
                      torch.zeros((SERVE_B,), dtype=torch.int32))
    out["step_collectives"] = {str(k).split(".")[-1]: v
                               for k, v in comm.get_comm_counts().items()}
    T.SHARD_CTX = None
    _train_checks(out_dir, out)
    out["jax_loaded"] = sys.modules.get("jax") is not None
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
