"""The port's collective-free distributed decode (``core/distributed_decode.py``,
the ``shard_map`` backend, ``SHARD_CTX``, ``serve --backend shard-map``,
``load_checkpoint(shardings=)``) against the reference's, and in one spawned
4-rank gloo world (``torch_dist_world.py``) on meshes (2, 2), (4, 1) and
(1, 4) against the one-process plain backend; the sharded train loop
(``train_loop(mesh=)``, checkpoints saved from DTensors) in the same world
against a world of one, and one sharded step against the reference's
sharded jit. Every number is drawn from a numpy seed."""
import dataclasses
import multiprocessing
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

import torch_dist_world as W
from repro.configs import get_smoke_config as j_smoke
from repro.core import distributed_decode as JD
from repro.core import kvcache as jkv
from repro.kernels.mla_decode import ref as JR
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import flatten, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import distributed_decode as TD
from repro_torch.core import kvcache as tkv
from repro_torch.kernels.mla_decode import backends as TB
from repro_torch.kernels.mla_decode import ref as TR
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as TS
from repro_torch.launch.train import train_loop
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def mesh11():
    """A (1, 1) ("data", "model") mesh over a gloo world of one started in
    this process, destroyed after the test."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, "cpu")
    yield mesh
    dist.destroy_process_group()


def _j_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# the region and the append at a world of one, against the reference
# ---------------------------------------------------------------------------

def test_applicability_rules(mesh11):
    assert TD.shard_map_applicable(mesh11, "data", 4, 8)
    assert TD.shard_map_applicable(mesh11, None, 1, 8)
    fake = types.SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    assert TD.shard_map_applicable(fake, "data", 4, 8)
    assert not TD.shard_map_applicable(fake, "data", 3, 8)
    assert not TD.shard_map_applicable(fake, None, 3, 6)


def _region_case(fmt, seed=0):
    """tests/test_distributed_decode.py:19-38's shapes, numpy-seeded: the
    reference's cache and prepared query, and the port's, byte for byte."""
    B, H, d_c, d_r, N, S = 2, 4, 32, 16, 64, 50
    rng = np.random.RandomState(seed)
    cfg = jkv.CacheConfig(fmt=fmt, page_size=32)
    cache = jkv.mla_prefill(jkv.init_mla_cache(cfg, B, N, d_c, d_r), cfg,
                            jnp.asarray(rng.standard_normal((B, S, d_c)) * 2, jnp.float32),
                            jnp.asarray(rng.standard_normal((B, S, d_r)) * 20, jnp.float32))
    q = JR.prepare_q(jnp.asarray(rng.standard_normal((B, H, d_c)), jnp.float32),
                     jnp.asarray(rng.standard_normal((B, H, d_r)) * 3, jnp.float32), fmt)
    tq = tuple(bridge.to_torch(np.asarray(x)) for x in q)
    return q, cache, tq, bridge.cache_from_jax(jax.tree.map(np.asarray, cache))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("splits", [1, 4])
def test_region_matches_reference(mesh11, fmt, splits):
    """The port's region at a world of one against the reference's
    ``mla_decode_shard_map`` on a (1, 1) mesh (the reference test's 1e-5),
    and bitwise against the plain parallel form it runs."""
    (q_c8, q_r, sq), cache, tq, tcache = _region_case(fmt)
    kw = dict(softmax_scale=0.1, block_n=16, fmt=fmt, num_splits=splits)
    mesh = _j_mesh()
    with mesh:
        want = jax.jit(lambda a, b, c: JD.mla_decode_shard_map(mesh, "data", a, b, c, cache,
                                                                **kw))(q_c8, q_r, sq)
    with CommDebugMode() as comm:
        got = TD.mla_decode_shard_map(mesh11, "data", *tq, tcache, **kw)
    assert comm.get_total_counts() == 0
    got = got.full_tensor()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain, _ = TR.snapmla_decode_parallel_any(tq[0], tq[1].float(), tq[2], tcache.content,
                                              tcache.rope.float(), tcache.scale,
                                              tcache.seq_lens, **kw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("gated", [False, True])
def test_append_matches_reference(mesh11, gated):
    """The collective-free append against the reference's ``mla_append``
    (tests/test_distributed_decode.py:41-82): content, rope and seq_lens
    bitwise, scale within 1e-6; gated-off rows keep their old slot and
    seq_lens. The region writes the rank's rows of the cache in place."""
    B, d_c, d_r, N, S = 4, 32, 16, 64, 20
    rng = np.random.RandomState(1)
    cfg = jkv.CacheConfig(fmt="fp8_e4m3", page_size=32)
    cache = jkv.mla_prefill(jkv.init_mla_cache(cfg, B, N, d_c, d_r), cfg,
                            jnp.asarray(rng.standard_normal((B, S, d_c)) * 2, jnp.float32),
                            jnp.asarray(rng.standard_normal((B, S, d_r)) * 20, jnp.float32))
    c_kv = rng.standard_normal((B, d_c)).astype(np.float32)
    k_r = (rng.standard_normal((B, d_r)) * 3).astype(np.float32)
    active = np.asarray([True, False, True, False])
    act = active if gated else None
    want = jax.jit(lambda c, k: jkv.mla_append(cache, cfg, c, k, active=act))(c_kv, k_r)
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, cache))
    before = tcache.content.clone()
    tcfg = tkv.CacheConfig(fmt="fp8_e4m3", page_size=32)
    with CommDebugMode() as comm:
        got = TD.mla_append_shard_map(mesh11, "data", tcache, tcfg, torch.from_numpy(c_kv),
                                      torch.from_numpy(k_r),
                                      active=torch.from_numpy(active) if gated else None)
    assert comm.get_total_counts() == 0
    assert got.content.to_local().data_ptr() == tcache.content.data_ptr()
    for name in ("content", "rope", "seq_lens"):
        assert torch.equal(_bits(getattr(got, name).full_tensor()),
                           _bits(bridge.to_torch(np.asarray(getattr(want, name))))), name
    np.testing.assert_allclose(got.scale.full_tensor().numpy(), np.asarray(want.scale),
                               rtol=1e-6, atol=1e-8)
    if gated:
        assert got.seq_lens.full_tensor().tolist() == [S + 1, S, S + 1, S]
        assert torch.equal(_bits(tcache.content[1::2, S]), _bits(before[1::2, S]))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as integers of its element width (fp8 / bf16 compared bit
    for bit)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


# ---------------------------------------------------------------------------
# the backend and its resolution (tests/test_backends.py:54-124)
# ---------------------------------------------------------------------------

def test_supports_kernel_rejects_multi_rank_mesh():
    ok, why = TB.get_backend("cuda_splitkv").supports(None, types.SimpleNamespace(size=8), 2)
    assert not ok and "rank mesh" in why
    assert TB.get_backend("cuda_splitkv").supports(None, types.SimpleNamespace(size=1), 2)[0]


def test_supports_shard_map_requires_mesh_and_divisibility():
    sm = TB.get_backend("shard_map")
    assert sm.kind == "shard_map" and sm.layout == "contiguous"
    assert not sm.supports(None, None, 2, n_heads=4)[0]
    mesh = types.SimpleNamespace(size=2, shape={"model": 2})
    assert sm.supports(None, mesh, 2, n_heads=4)[0]
    ok, why = sm.supports(None, mesh, 2, n_heads=3)
    assert not ok and "divide" in why
    assert not sm.supports(None, mesh, 2, paged=True, n_heads=4)[0]
    ok, why = sm.supports(None, mesh, 2, n_heads=4, q_len=5)
    assert not ok and "q_len=5" in why


def test_resolve_auto_defaults_to_ref_twin():
    assert TB.resolve_backend("auto", paged=False, batch=2).name == "torch_ref"
    assert TB.resolve_backend("auto", paged=True, batch=2).name == "torch_paged_ref"


def test_resolve_auto_use_kernels_selects_kernels():
    assert TB.resolve_backend("auto", paged=False, batch=2,
                              use_kernels=True).name == "cuda_splitkv"
    assert TB.resolve_backend("auto", paged=True, batch=2,
                              use_kernels=True).name == "cuda_paged_splitkv"
    # a multi-rank mesh degrades auto back to the ref twin (no raise)
    mesh8 = types.SimpleNamespace(size=8, shape={"model": 8})
    assert TB.resolve_backend("auto", paged=False, batch=2, n_heads=3, mesh=mesh8,
                              use_kernels=True).name == "torch_ref"


def test_resolve_auto_prefers_shard_map_when_applicable():
    mesh = types.SimpleNamespace(size=2, shape={"model": 2})
    assert TB.resolve_backend("auto", paged=False, batch=2, n_heads=4, mesh=mesh,
                              prefer_shard_map=True).name == "shard_map"
    assert TB.resolve_backend("auto", paged=False, batch=2, n_heads=3, mesh=mesh,
                              prefer_shard_map=True).name == "torch_ref"
    assert TB.resolve_backend("auto", paged=True, batch=2, n_heads=4, mesh=mesh,
                              prefer_shard_map=True).name == "torch_paged_ref"
    # a verify block routes away from the one-token region
    assert TB.resolve_backend("auto", paged=False, batch=2, n_heads=4, mesh=mesh,
                              prefer_shard_map=True, q_len=3).name == "torch_ref"


def test_resolve_aliases_follow_cache_layout():
    assert TB.canonical_name("shard-map", False) == "shard_map"
    assert TB.resolve_backend("ref", paged=True, batch=2).name == "torch_paged_ref"
    assert TB.resolve_backend("kernel", paged=True, batch=2).name == "cuda_paged_splitkv"
    assert TB.resolve_backend("kernel", paged=False, batch=2).name == "cuda_splitkv"
    assert TB.resolve_backend("cuda_splitkv", paged=False, batch=2).name == "cuda_splitkv"
    mesh = types.SimpleNamespace(size=1, shape={"data": 1, "model": 1})
    assert TB.resolve_backend("shard-map", batch=2, n_heads=4, mesh=mesh,
                              dp="data").name == "shard_map"


def test_resolve_explicit_unsupported_raises():
    with pytest.raises(ValueError, match="shard_map"):
        TB.resolve_backend("shard-map", paged=False, batch=2, n_heads=4)
    with pytest.raises(ValueError, match="PagedMLAPool"):
        TB.resolve_backend("shard-map", paged=True, batch=2, n_heads=4,
                           mesh=types.SimpleNamespace(size=1, shape={"model": 1}))
    with pytest.raises(ValueError, match="rank mesh"):
        TB.resolve_backend("kernel", paged=False, batch=2, mesh=types.SimpleNamespace(size=8))
    with pytest.raises(ValueError, match="unknown decode backend"):
        TB.resolve_backend("triton", paged=False, batch=2)


def test_shard_map_decode_needs_ctx_and_one_token(mesh11):
    (_, _, _), _, tq, tcache = _region_case("fp8_e4m3")
    cfg = TB.BackendConfig(softmax_scale=0.1, block_n=16, num_splits=1)
    sm = TB.get_backend("shard_map")
    with pytest.raises(ValueError, match="ctx"):
        sm.decode(TB.DecodeQuery(*tq), tcache, cfg)
    with pytest.raises(ValueError, match="q_len > 1"):
        sm.decode(TB.DecodeQuery(*(t[:, None] for t in tq)), tcache, cfg,
                  {"mesh": mesh11, "dp": "data"})
    got = sm.decode(TB.DecodeQuery(*tq), tcache, cfg, {"mesh": mesh11, "dp": "data"})
    assert torch.equal(got, TB.get_backend("torch_ref").decode(TB.DecodeQuery(*tq), tcache,
                                                               cfg))


# ---------------------------------------------------------------------------
# the slice: a decode step under SHARD_CTX, and serve
# ---------------------------------------------------------------------------

def _state_from_jax(jstate, cfg):
    """The reference's decode state (contiguous MLA caches, as numpy) in the
    port's layer order (superblock i, slot j is layer i * pattern_len + j)."""
    layers = []
    for i in range(cfg.n_superblocks):
        for slot in jstate["scanned"]:
            layers.append(bridge.cache_from_jax(jax.tree.map(lambda a: np.asarray(a)[i], slot)))
    layers += [bridge.cache_from_jax(jax.tree.map(np.asarray, c)) for c in jstate["tail"]]
    return {"layers": layers, "aux": None}


def test_decode_step_matches_reference_under_shard_ctx(mesh11):
    """One decode step of the smoke mla-7b (contiguous cache) under the
    port's ``SHARD_CTX`` at a world of one against the reference's
    ``decode_step`` under its ``SHARD_CTX`` on a (1, 1) mesh of Auto axes (an
    Explicit-axis mesh makes the reference's ``_wsc`` raise under jax 0.9):
    logits within 1e-5, and bitwise equal to the port's ``ref`` step."""
    from jax.sharding import AxisType
    Bs, Ss = 4, 12
    jcfg = dataclasses.replace(j_smoke("mla-7b"), decode_backend="shard-map")
    jparams = jax.jit(lambda k: JT.init_model(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    prompts = rng.randint(0, jcfg.vocab_size, (Bs, Ss)).astype(np.int32)
    tok = rng.randint(0, jcfg.vocab_size, (Bs,)).astype(np.int32)
    state = JT.init_decode_state(jcfg, Bs, 32)
    _, state = jax.jit(jsteps.make_prefill_step(dataclasses.replace(
        jcfg, decode_backend="ref")))(jparams, prompts, state)
    pos = jnp.full((Bs,), Ss, jnp.int32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    JT.SHARD_CTX = {"mesh": jmesh, "dp": "data", "use_shard_map": True}
    try:
        with jmesh:
            want, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, tok, state, pos)
    finally:
        JT.SHARD_CTX = None
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    tstate = _state_from_jax(jax.tree.map(np.asarray, state), jcfg)
    tcfg = dataclasses.replace(t_smoke("mla-7b"), decode_backend="shard-map")
    ttok, tpos = torch.from_numpy(tok), torch.full((Bs,), Ss, dtype=torch.int32)
    plain, _ = TT.decode_step(tparams, dataclasses.replace(tcfg, decode_backend="ref"), ttok,
                              _state_from_jax(jax.tree.map(np.asarray, state), jcfg), tpos)
    TT.SHARD_CTX = {"mesh": mesh11, "dp": "data", "use_shard_map": True}
    try:
        with CommDebugMode() as comm:
            got, new_state = TT.decode_step(tparams, tcfg, ttok, tstate, tpos)
    finally:
        TT.SHARD_CTX = None
    assert comm.get_total_counts() == 0
    assert all(not hasattr(t, "placements") for c in new_state["layers"] for t in c
               if t is not None)
    assert [c.seq_lens.tolist() for c in new_state["layers"]] == [[Ss + 1] * Bs] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, plain)


def test_serve_main_shard_map_cpu(capsys):
    """``serve --backend shard-map`` starts its world of one without a
    launcher (and ends it), gives the ``ref`` backend's tokens; ``--engine``
    refuses it (the engine's pool is paged)."""
    assert not dist.is_initialized()
    flags = ["--smoke", "--device", "cpu", "--gen", "4"]
    tserve.main(flags + ["--backend", "shard-map"])
    out = capsys.readouterr().out
    assert not dist.is_initialized() and TT.SHARD_CTX is None
    assert "backend=shard-map" in out and "rank 0 of 1 (mesh (1, 1))" in out
    tokens = out.split("tokens ")[1].splitlines()[0]
    cfg = t_smoke("mla-7b")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_model(gen, cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen, dtype=torch.int64)
    ref, _ = tserve.generate(dataclasses.replace(cfg, decode_backend="ref"), params, prompts, 4)
    assert tokens == str(ref.tolist())
    with pytest.raises(ValueError, match="PagedMLAPool"):
        tserve.main(flags + ["--engine", "--backend", "shard-map"])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the spawned 4-rank gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def world_started(tmp_path_factory):
    """Starts one gloo world of ``W.WORLD`` spawned ranks
    (``torch_dist_world.run``, initialised through a ``file://`` store) when
    the module starts, so the ranks run beside its other tests; kills any
    rank still alive when the module ends."""
    root = tmp_path_factory.mktemp("world")
    save_checkpoint(str(root / "ckpt"), 1, W.ckpt_tree())
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, W.WORLD, str(root / "store"),
                                             str(root / "ckpt"), str(root)))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    yield root, procs
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


@pytest.fixture(scope="module")
def world(world_started):
    """Each rank's results, once every rank has exited with 0."""
    root, procs = world_started
    for p in procs:
        p.join(timeout=300)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * W.WORLD, codes
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(W.WORLD)]


@pytest.mark.parametrize("shape", W.MESHES)
def test_world_region_matches_one_process(world, shape, record_property):
    """The gathered region on every rank within 1e-6 of the one-process
    ``torch_ref`` backend on the same inputs, 0 collectives inside it, and
    each rank's shard (B / dp, H / model, d_c)."""
    worst = 0.0
    for fmt, splits in W.REGION_CASES:
        q, cache, _ = W.region_inputs(fmt, sink=W.SINK if splits == 4 else 0)
        cfg = TB.BackendConfig(softmax_scale=W.SCALE, block_n=16, fmt=fmt, num_splits=splits)
        want = TB.get_backend("torch_ref").decode(TB.DecodeQuery(*q), cache, cfg)
        for rank in world:
            got = rank[("region", shape, fmt, splits)]
            assert got["collectives"] == 0
            assert got["local"] == (W.B // shape[0], W.H // shape[1], W.D_C)
            worst = max(worst, float((got["o"] - want).abs().max()))
            torch.testing.assert_close(got["o"], want, rtol=0, atol=1e-6)
    record_property("max_abs_diff", worst)


@pytest.mark.parametrize("shape", W.MESHES)
def test_world_append_matches_one_process(world, shape):
    """Each rank appends its rows with 0 collectives; gathered, the cache
    (sink shadow included) equals the one-process ``mla_append`` bitwise."""
    c_kv, k_r, active = W.append_inputs()
    for gated in (False, True):
        _, cache, ccfg = W.region_inputs("fp8_e4m3", sink=W.SINK)
        want = tkv.mla_append(cache, ccfg, c_kv, k_r, active=active if gated else None)
        for rank in world:
            got = rank[("append", shape, gated)]
            assert got["collectives"] == 0
            assert len(got["cache"]) == 5
            for g, w in zip(got["cache"], want):
                assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("shape", W.MESHES)
def test_world_placements_give_spec_shard_shapes(world, shape):
    """``to_named`` / ``place``: every leaf's local shard has the shape its
    spec implies on that mesh, with one placement per mesh dimension."""
    from repro_torch.launch import sharding as SH
    params = W.ckpt_tree()
    fake = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))
    specs = {}
    SH.map_with_path(lambda path, ps: specs.__setitem__("/".join(map(str, path)), ps),
                     SH.param_pspecs(params, fake), leaf=SH.P)
    want = []
    for path, leaf in flatten(params):
        local = list(leaf.shape)
        for dim, axes in enumerate(specs[path]):
            for a in (axes if isinstance(axes, tuple) else (axes,) if axes else ()):
                local[dim] //= fake.shape[a]
        want.append((path, tuple(local)))
    assert any(s != tuple(leaf.shape) for (_, s), (_, leaf) in zip(want, flatten(params)))
    for rank in world:
        got = rank[("placed", shape)]
        assert [(p, s) for p, s, _ in got] == want
        assert all(len(pl) == 2 for _, _, pl in got)


@pytest.mark.parametrize("shape", W.MESHES)
def test_world_load_checkpoint_reshards(world, shape):
    """``load_checkpoint(shardings=)``: DTensors with the requested
    placements whose ``full_tensor()`` equals the saved tree
    (tests/test_checkpoint.py:34-43)."""
    for rank in world:
        got = rank[("ckpt", shape)]
        assert got["placements_ok"] and got["equal"]
        assert got["leaves"] == len(flatten(W.ckpt_tree()))


def test_world_serve_generate_gives_ref_tokens(world):
    """``serve.generate`` with ``shard-map`` over ``make_host_mesh(1)`` (a
    (4, 1) mesh): every rank gives the one-process ``ref`` backend's greedy
    tokens; a decode step's only collectives are the two gathers per layer
    outside the region (o_latent and seq_lens). No rank imported JAX."""
    cfg, params, prompts = W.serve_setup()
    want, _ = tserve.generate(dataclasses.replace(cfg, decode_backend="ref"), params, prompts,
                              W.SERVE_GEN)
    for rank in world:
        assert rank["serve"]["mesh"] == (W.WORLD, 1)
        assert torch.equal(rank["serve"]["tokens"], want)
        assert rank["step_collectives"] == {"all_gather_into_tensor": 2 * cfg.n_layers}
        assert not rank["jax_loaded"]


# ---------------------------------------------------------------------------
# the train loop on a mesh
# ---------------------------------------------------------------------------

def _one_process_run(arch):
    """``train_loop`` on a world of one started (and ended) by the loop."""
    assert not dist.is_initialized()
    r = train_loop(t_smoke(arch), ckpt_dir=None, device="cpu", **W.TRAIN)
    assert not dist.is_initialized()
    return r


@pytest.fixture(scope="module")
def one_process_runs():
    return {arch: _one_process_run(arch) for arch in W.TRAIN_ARCHS}


@pytest.mark.parametrize("arch", W.TRAIN_ARCHS)
@pytest.mark.parametrize("shape", W.TRAIN_MESHES)
def test_world_train_loop_matches_one_process(world, one_process_runs, arch, shape):
    """``train_loop`` on a (2, 2) and a (4, 1) mesh: every rank's losses
    within rtol 1e-5 and its final parameters within atol 1e-6 of the run on
    a world of one (only the order of the reductions differs); the
    grad_norm covers the whole gradient and the loss is the mean over the
    whole batch, not a mean of per-rank means."""
    want = one_process_runs[arch]
    for rank in world:
        got = rank[("train", arch, shape)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        leaves = tree_leaves(want["params"])
        assert len(got["params"]) == len(leaves)
        for g, w in zip(got["params"], leaves):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_world_preempt_resume_across_meshes(world):
    """A run on the (2, 2) mesh preempted after step 2 (its checkpoint
    written once, by rank 0) and resumed on the (4, 1) mesh ends within
    1e-6 of the unbroken run on the (2, 2) mesh."""
    arch = W.TRAIN_ARCHS[0]
    for r, rank in enumerate(world):
        want = rank[("train", arch, W.TRAIN_MESHES[0])]
        got = rank["preempt"]
        assert got["status"] == "preempted" and got["final_step"] == W.PREEMPT_AT
        assert got["published"] == [f"step_{W.PREEMPT_AT:08d}"]
        assert got["writes"] == (1 if r == 0 else 0)
        assert got["resumed_final"] == W.TRAIN["steps"]
        np.testing.assert_allclose(got["resumed_losses"], want["losses"][W.PREEMPT_AT:],
                                   rtol=1e-6)
        assert len(got["params"]) == len(want["params"])
        for g, w in zip(got["params"], want["params"]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_world_train_step_collectives(world, record_property):
    """One sharded train step on the (2, 2) mesh issues collectives (the
    gradient's reductions and the FSDP gathers); the counts are recorded."""
    for rank in world:
        counts = rank["train_collectives"]
        assert counts.get("all_reduce", 0) + counts.get("reduce_scatter_tensor", 0) > 0
        assert counts.get("all_gather_into_tensor", 0) > 0
    record_property("train_step_collectives", world[0]["train_collectives"])


def test_world_checkpoint_saved_on_mesh_loads_on_one_process(world_started, world):
    """The checkpoint the world saved from its (4, 1) placement loads in one
    process with no mesh and equals the tree it placed."""
    root, _ = world_started
    got, manifest = load_checkpoint(str(root / "saved_on_4x1" / "step_00000001"),
                                    W.ckpt_tree())
    assert manifest["step"] == 1
    for (p, g), (_, w) in zip(flatten(got), flatten(W.ckpt_tree())):
        assert torch.equal(g, w), p


def test_checkpoint_of_dtensors_equals_one_device_save(mesh11, tmp_path):
    """``save_checkpoint`` of DTensors (a world of one, the training
    placements) writes the bytes and manifest a save of the plain tensors
    writes."""
    from repro_torch.launch import sharding as SH
    params = W.ckpt_tree()
    placed = SH.place(params, SH.to_named(SH.param_pspecs(params, mesh11), mesh11))
    a = save_checkpoint(str(tmp_path / "a"), 3, placed, {"x": 1})
    b = save_checkpoint(str(tmp_path / "b"), 3, params, {"x": 1})
    for name in ("manifest.json", "arrays.npz"):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_sharded_train_step_matches_reference(mesh11):
    """One ``train.sharded_step`` at a world of one against the reference's
    train step jitted with its in / out shardings on a (1, 1) mesh of Auto
    axes (``make_host_mesh`` makes Explicit axes under jax 0.9), on the same
    bridged weights and batch: new params, moments and metrics within the
    train-step tests' 1e-5."""
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as JP

    from repro.launch import sharding as JSH
    from repro.optim.adamw import init_adamw as j_init_adamw
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import sharded_step
    from repro_torch.optim.adamw import init_adamw
    from torch_grad_check import batch, jax_model
    arch = "mla-7b"
    jcfg, jparams, tparams = jax_model(arch)
    toks, labels, _ = batch(jcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jopt = j_init_adamw(jparams)
    jstep = jsteps.make_train_step(jcfg, warmup_steps=2, total_steps=10)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ins = (JSH.param_pspecs(jparams, jmesh), JSH.param_pspecs(jopt, jmesh),
           JSH.batch_pspecs(jb, jmesh), JP())
    metrics = jax.eval_shape(jstep, jparams, jopt, jb, jnp.int32(3))[2]
    outs = (ins[0], ins[1], jax.tree.map(lambda _: JP(), metrics))
    with jmesh:
        jp, jo, jm = jax.jit(jstep, in_shardings=JSH.to_named(ins, jmesh),
                             out_shardings=JSH.to_named(outs, jmesh))(
            jparams, jopt, jb, jnp.int32(3))
    topt = init_adamw(tparams)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    placed = (SH.place(tparams, SH.to_named(SH.param_pspecs(tparams, mesh11), mesh11)),
              SH.place(topt, SH.to_named(SH.param_pspecs(topt, mesh11), mesh11)),
              SH.place(tb, SH.to_named(SH.batch_pspecs(tb, mesh11), mesh11)))
    tp, to, tm = sharded_step(TS.make_train_step(t_smoke(arch), warmup_steps=2,
                                                 total_steps=10), mesh11)(*placed, 3)
    tol = dict(rtol=1e-5, atol=1e-5)
    for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        want = flatten(bridge.params_from_jax(jax.tree.map(np.asarray, want)))
        got = flatten(got)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert type(g).__name__ == "DTensor", path
            np.testing.assert_allclose(g.full_tensor().numpy(), w.numpy(), err_msg=path, **tol)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **tol)
