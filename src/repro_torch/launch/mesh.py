"""Device meshes over ``torch.distributed`` (mirrors ``repro.launch.mesh``).

The data axis of a JAX mesh becomes a process group: ``nccl`` on the card,
``gloo`` on the CPU.  A mesh is a ``torch.distributed.DeviceMesh`` with
named dims, built by :func:`make_mesh` (a function, so importing this
module touches no device or process group).  Where no process group is up
yet, :func:`init_process_group` starts one from a ``FileStore`` in a
temporary directory, which needs no network; a world of several processes
passes each of them the same ``store_path``, its rank and the world size.
The production mesh (``make_production_mesh``) comes with the
tensor-parallel rules (ROADMAP A13b).
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


def make_host_mesh():
    """1-process mesh for CPU example runs."""
    return make_mesh((1, 1), ("data", "model"), "cpu")
