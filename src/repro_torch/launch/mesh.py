"""Device meshes over ``torch.distributed`` (mirrors ``repro.launch.mesh``).

The data axis of a JAX mesh becomes a process group: ``nccl`` on the card,
``gloo`` on the CPU.  A mesh is a ``torch.distributed.DeviceMesh`` with
named dims, built by :func:`make_mesh` (a function, so importing this
module touches no device or process group).  Where no process group is up
yet, :func:`init_process_group` starts one from a ``FileStore`` in a
temporary directory, which needs no network; a world of several processes
passes each of them the same ``store_path``, its rank and the world size.

The production meshes are the JAX package's: 16 x 16 ("data", "model"),
or two pods, 2 x 16 x 16 ("pod", "data", "model").  A world of 256 or 512
processes is not something one host starts, so the dry run builds them
over a **fake** process group (:func:`make_fake_mesh`): one process that
plays rank 0 of a world of the mesh's size, whose collectives return at
once and move nothing.  The default process group is global to a process:
a fake group lives in a process of its own (the dry run's, or a
subprocess), where it cannot meet a real one.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

# re-exported: the degree and the group of a mesh's data-parallel dims live
# with the span plumbing, which the optimizer core imports
from repro_torch.sharding.rules import (  # noqa: F401
    axes_group, data_parallel_degree)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_process_group(backend: str, *, rank: int = 0, world_size: int = 1,
                       store_path: Optional[str] = None) -> None:
    """Start the default process group from a ``FileStore`` at
    ``store_path`` (a new file in a temporary directory by default, which
    serves a world of one process)."""
    if store_path is None:
        store_path = os.path.join(tempfile.mkdtemp(prefix="repro_pg_"),
                                  "store")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def make_mesh(shape, axes, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group (started for a world of one process when there
    is none).  ``device_type``: "cuda" when a card is present, else
    "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        init_process_group(default_backend(device_type))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# (shape, dim names) of the production meshes: a pod, and two pods
POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 = 256 devices per pod, or 2 pods = 512 devices, over the
    default process group, which must have that many ranks (a fake one:
    :func:`make_fake_mesh`)."""
    return make_mesh(*(MULTI_POD if multi_pod else POD), device_type)


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """Start the default process group as a fake one of ``world_size``
    ranks, this process being ``rank``: every collective completes at once
    without moving data (``torch``'s testing backend "fake")."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_fake_mesh(shape, axes):
    """A "cpu" ``DeviceMesh`` of ``shape`` over a fake process group of
    ``prod(shape)`` ranks (started here when no group is up; an existing
    group must be a fake one of that size)."""
    size = 1
    for s in shape:
        size *= int(s)
    if not dist.is_initialized():
        init_fake_process_group(size)
    elif dist.get_backend() != "fake" or dist.get_world_size() != size:
        raise RuntimeError(
            f"make_fake_mesh needs a fake process group of {size} ranks; this "
            f"process has a {dist.get_backend()!r} group of "
            f"{dist.get_world_size()}")
    return make_mesh(shape, axes, "cpu")


def make_host_mesh():
    """1-process mesh for CPU example runs."""
    return make_mesh((1, 1), ("data", "model"), "cpu")
