"""The device mesh of a multi-card run: which process is which rank, on which
card, and the process group of each mesh axis.

Counterpart of ``deepv_tpu/parallel/mesh.py``. deepv_tpu's ``Mesh`` is one
program's view of all chips; the port runs one process per rank over
``torch.distributed``, so ``make_mesh`` is called by every rank inside an
initialised process group (``parallel/launch.spawn`` starts one) and
returns this rank's view: its coordinates, its ``torch.device`` and the
groups of the axes. Ranks lie on the mesh in row-major order, as
``np.arange(n).reshape(axis_sizes)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``groups`` maps each axis name to the
    process group of the ranks that differ from this one only along it."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axis: str):
        return self.groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        i = self.axis_names.index(axis)
        return (self.rank // math.prod(self.axis_sizes[i + 1:])) % self.axis_sizes[i]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None, backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` over the initialised default process group,
    whose size must be ``prod(axis_sizes)``.

    By default each rank runs on its own card, ``cuda:<rank>``, over NCCL;
    a world larger than ``torch.cuda.device_count()`` raises. ``devices``
    names each rank's device explicitly (``["cpu"] * n`` for the CPU), and
    ``backend`` the backend the group must run: the group's backend is
    checked, never switched. Two ranks may share a card only over gloo, when
    both are asked for explicitly (``devices=["cuda:0", "cuda:0"],
    backend="gloo"``): NCCL refuses it. Every rank must call this in the
    same order, since a mesh of more than one axis creates groups."""
    axis_sizes, axis_names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
    if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names} do not match sizes {axis_sizes}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh runs inside an initialised torch.distributed process "
                           "group, one process per rank (parallel/launch.spawn starts them)")
    n, world, rank = math.prod(axis_sizes), dist.get_world_size(), dist.get_rank()
    if n != world:
        raise ValueError(f"a mesh of {axis_sizes} needs {n} ranks; the process group has "
                         f"{world}")
    backend = backend or "nccl"
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks for "
                         f"{backend!r}")
    if devices is None:
        cards = torch.cuda.device_count()
        if n > cards:
            raise RuntimeError(f"a mesh of {n} ranks, one per card, needs {n} CUDA cards; "
                               f"this machine has {cards}")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n} ranks")
    cuda = [d for d in devices if d.type == "cuda"]
    if backend == "nccl" and (len(cuda) != n or len(set(cuda)) != n):
        raise ValueError(f"NCCL runs one rank per card; got devices {[str(d) for d in devices]}")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    groups = {}
    ranks = torch.arange(n).reshape(axis_sizes)
    for i, name in enumerate(axis_names):
        if len(axis_sizes) == 1:
            groups[name] = dist.group.WORLD
            continue
        # every line of ranks along axis i is one group; all ranks create all
        lines = ranks.movedim(i, -1).reshape(-1, axis_sizes[i]).tolist()
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    return Mesh(axis_names, axis_sizes, rank, device, groups)
