"""Device meshes (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with named dimensions: ``("data", "model")``, or
``("pod", "data", "model")`` for the multi-pod production shape. The
process group's backend follows the device: NCCL on ``cuda``, gloo on
``cpu``; a world that already runs the other backend is refused, never
switched.

Defined as functions, so importing this module starts no process group.

The sharding rules (``launch/sharding.py``) read a mesh through
``axis_names`` / ``axis_sizes`` only, so they also take any object with
``axis_names`` and a ``shape`` mapping each name to its size (the fake
meshes of the tests), as the reference's rules read ``mesh.shape`` and
``mesh.axis_names``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)           # 256 chips per pod
MULTI_POD_SHAPE = (2, 16, 16)
MESH_SIZES = {"pod": 256, "multipod": 512}   # the dry run's worlds


def backend_for(device_type: str) -> str:
    """The process-group backend a mesh on ``device_type`` runs on."""
    return "nccl" if device_type == "cuda" else "gloo"


def _ensure_world(device_type: str) -> None:
    """Join the world that exists, or start one: from ``torchrun``'s
    environment when it set one, else a world of one in this process (a
    ``HashStore``: no launcher, no port)."""
    want = backend_for(device_type)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(want)
        else:
            dist.init_process_group(want, store=dist.HashStore(), rank=0, world_size=1)
        return
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(f"a mesh on {device_type!r} needs the {want} backend, but the "
                           f"process group runs {have}")


def _make(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks per pod; ``multi_pod`` adds a leading 2-pod axis.
    Builds only inside a world of exactly that size (a real one, or the fake
    process group over meta tensors)."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"the production mesh {shape} needs a world of {need} ranks, "
                         f"this one has {have}")
    return _make(device_type, shape, names)


def make_host_mesh(model_parallel: int = 1, device: "str | torch.device" = "cuda"):
    """A ``("data", "model")`` mesh over every rank of the world, with
    ``model_parallel`` ranks on ``model``; starts a world of one when there
    is none (the reference's ``make_host_mesh`` needs no launcher either)."""
    device_type = torch.device(device).type
    _ensure_world(device_type)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world of {n}")
    return _make(device_type, (n // model_parallel, model_parallel), ("data", "model"))


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Each axis name -> its size."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    """The number of ranks (devices) in the mesh."""
    size = mesh.size
    return size() if callable(size) else size


def data_axis_names(mesh) -> tuple[str, ...]:
    """Axes carrying the batch / FSDP dimension ('pod' folds into data)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"] if "model" in axis_names(mesh) else 1
