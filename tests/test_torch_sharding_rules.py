"""The port's sharding rules (``launch/sharding.py``) and meshes
(``launch/mesh.py``) against the reference's: every parameter and
decode-state leaf of all 12 arch ids' full configs gets the reference's
spec (the reference's scanned stacks mapped to the port's layer list), on
a (data 16, model 16) and a (pod 2, data 16, model 16) mesh; the cases of
tests/test_sharding_rules.py; and the specs as DTensor placements."""
import pickle

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, get_config as j_config
from repro.launch import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_config
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TS
from repro_torch.launch.sharding import P
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


class FakeMesh:
    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = (FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16))
PARAM_MODES = ({}, {"weight_stationary": True}, {"attn_fallback": "shard_dh"})
STATE_BATCHES = (64, 1)


def _key(k) -> str:
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def ref_specs_by_port_path(tree, cfg) -> dict:
    """The reference's spec tree keyed by the port's leaf paths: superblock
    i, slot j of ``scanned`` is layer ``i * pattern_len + j`` (its spec is
    ``P(None, *core)``: the port's leaf gets ``core``), then the ``tail``;
    the ``encoder`` stack is one layer per entry (``bridge.params_from_jax``'s
    order)."""
    out, n = {}, len(cfg.layer_pattern)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        keys, spec = [_key(k) for k in path], tuple(spec)
        if keys[0] == "scanned":
            for i in range(cfg.n_superblocks):
                out["/".join(["layers", str(i * n + int(keys[1]))] + keys[2:])] = spec[1:]
        elif keys[0] == "tail":
            out["/".join(["layers", str(cfg.n_superblocks * n + int(keys[1]))]
                         + keys[2:])] = spec
        elif keys[0] == "encoder":
            for i in range(cfg.encoder_layers):
                out["/".join(["encoder", str(i)] + keys[1:])] = spec[1:]
        else:
            out["/".join(keys)] = spec
    return out


def port_specs_by_path(tree) -> dict:
    out = {}
    TS.map_with_path(lambda path, ps: out.__setitem__("/".join(map(str, path)), tuple(ps)),
                     tree, leaf=P)
    return out


def _assert_same(want: dict, got: dict, what: str) -> None:
    diff = sorted((k, want.get(k), got.get(k)) for k in set(want) | set(got)
                  if want.get(k) != got.get(k))
    assert not diff, (what, diff[:5], len(diff))
    assert want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference_on_full_configs(arch):
    """param_pspecs (default, weight_stationary, attn_fallback='shard_dh'),
    state_pspecs (batch 64 and 1) and batch_pspecs equal the reference's,
    leaf for leaf. The reference runs on ``jax.eval_shape``, the port on
    ``meta`` tensors."""
    jc, tc = j_config(arch), t_config(arch)
    jparams = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jc))
    tparams = TT.init_model(torch.Generator(), tc, device="meta")
    states = [(jax.eval_shape(lambda b=b: JT.init_decode_state(jc, b, 4096)),
               TT.init_decode_state(tc, b, 4096, device="meta")) for b in STATE_BATCHES]
    for mesh in MESHES:
        for kw in PARAM_MODES:
            _assert_same(ref_specs_by_port_path(JS.param_pspecs(jparams, mesh, **kw), jc),
                         port_specs_by_path(TS.param_pspecs(tparams, mesh, **kw)),
                         (arch, mesh.shape, kw))
        for jstate, tstate in states:
            _assert_same(ref_specs_by_port_path(JS.state_pspecs(jstate, mesh, jc), jc),
                         port_specs_by_path(TS.state_pspecs(tstate, mesh, tc)),
                         (arch, mesh.shape, "state"))
        batch = {"tokens": torch.empty((64, 4096), device="meta"),
                 "one": torch.empty((1, 8), device="meta")}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.float32)
                  for k, v in batch.items()}
        assert ({k: tuple(v) for k, v in JS.batch_pspecs(jbatch, mesh).items()}
                == {k: tuple(v) for k, v in TS.batch_pspecs(batch, mesh).items()})


def test_sanitize_drops_nondivisible_axes():
    class Fake:
        shape = {"model": 16, "data": 4}
    assert TS.sanitize_pspec(P("model", "data"), (49155, 2048), Fake()) == P(None, "data")
    assert TS.sanitize_pspec(P("model", None), (32, 8), Fake()) == P("model", None)
    assert TS.sanitize_pspec(P(("data", "model")), (64, 3), Fake()) == P(("data", "model"), None)


def test_attn_fallback_policy():
    """Heads not divisible by the model axis: train replicates, decode may
    shard head_dim."""
    rules_train = TS._rules("data", "model", 16, attn_fallback="replicate")
    rules_serve = TS._rules("data", "model", 16, attn_fallback="shard_dh")
    shape = (3072, 24, 128)     # llama3.2-3b wq: H=24 not divisible by 16
    assert rules_train["wq"](shape) == P("data", None, None)
    assert rules_serve["wq"](shape) == P("data", None, "model")
    assert rules_train["wq"]((3072, 32, 128)) == P("data", "model", None)
    # xLSTM contraction operands are never model-sharded
    assert rules_train["w_q"]((2048, 4, 512)) == P("data", None, None)
    assert rules_train["w_v"]((2048, 4, 512)) == P("data", None, "model")


@pytest.fixture
def host_mesh():
    """``make_host_mesh(1)`` over a gloo world of one in this process,
    destroyed after the test."""
    assert not dist.is_initialized()
    mesh = TM.make_host_mesh(1, "cpu")
    yield mesh
    dist.destroy_process_group()


def test_dp_axes_for_small_batch(host_mesh):
    assert TM.axis_names(host_mesh) == ("data", "model")
    assert TM.axis_sizes(host_mesh) == {"data": 1, "model": 1}
    assert TM.mesh_size(host_mesh) == 1 and TM.model_axis_size(host_mesh) == 1
    big = TS.dp_axes_for(16 * TS.dp_size(host_mesh), host_mesh)
    assert big == "data"
    assert TS.dp_axes_for(1, host_mesh) is None or TS.dp_size(host_mesh) == 1
    pod = MESHES[1]
    assert TS.dp_size(pod) == 32 and TS.dp_axes_for(64, pod) == ("pod", "data")
    assert TS.dp_axes_for(16, pod) is None


def test_host_mesh_refuses_other_backend(host_mesh):
    """The device decides the backend: a gloo world does not carry a cuda mesh."""
    with pytest.raises(RuntimeError, match="nccl"):
        TM.make_host_mesh(1, "cuda")
    with pytest.raises(ValueError, match="does not divide"):
        TM.make_host_mesh(2, "cpu")


def test_placements_follow_specs():
    from torch.distributed.tensor import Replicate, Shard
    pod = MESHES[1]
    assert TS.placements_for(P(("pod", "data"), "model"), pod) == (Shard(0), Shard(0), Shard(1))
    assert TS.placements_for(P("model", None), pod) == (Replicate(), Replicate(), Shard(0))
    assert TS.placements_for(P(), pod) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="major first"):
        TS.placements_for(P(("data", "pod")), pod)
    with pytest.raises(ValueError, match="two dimensions"):
        TS.placements_for(P("model", "model"), pod)
    named = TS.to_named({"w": P("data", None), "l": [P(None)]}, pod)
    assert named["w"].placements == (Replicate(), Shard(0), Replicate())
    assert named["l"][0].spec == P(None) and named["w"].mesh is pod
    assert repr(P("data", None)) == "P('data', None)"
    assert pickle.loads(pickle.dumps(P(("pod", "data"), None))) == P(("pod", "data"), None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_a_world_of_its_size(multi_pod):
    """The production mesh builds only in a world of 256 (512) ranks: here
    the fake process group's."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a world"):
        TM.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    size = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=size)
    try:
        mesh = TM.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
        assert TM.axis_sizes(mesh) == want
        assert TM.data_axis_names(mesh) == (("pod", "data") if multi_pod else ("data",))
        assert TS.dp_size(mesh) == size // 16 and TM.model_axis_size(mesh) == 16
    finally:
        dist.destroy_process_group()
