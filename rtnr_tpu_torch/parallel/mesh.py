"""Process mesh over ``torch.distributed``: one process a rank (SPMD).

Counterpart of ``rtnr_tpu/parallel/mesh.py``. JAX is single-controller: a
``Mesh`` of devices and ``shard_map`` bodies with ``pmin`` / ``psum`` /
``axis_index`` inside. Here every rank runs the same function on its own
part, and the mesh is a grid of ranks: ``make_mesh((2, 2))`` puts rank r at
the row-major coordinates of ``np.arange(world).reshape(2, 2)``, the order
in which JAX reshapes its device list, so rank r holds the block of points
and frames that JAX's device r holds.

``Mesh`` is a thin class, not ``torch.distributed.device_mesh.DeviceMesh``:
several ranks share one card when the machine has fewer cards than ranks,
which DeviceMesh's one-device-a-rank model does not describe, and the
collectives below need each axis's group and the rank's place on it, which
the class keeps.

Axis conventions (as in JAX): ``"points"`` shards the cloud (z-buffers merge
with ``pmin``, colour sums with ``psum``), ``"batch"`` the frames,
``"tiles"`` the image rows (``parallel/tiles.py``).

``init_distributed`` joins the launcher's world (``torchrun`` /
``python -m torch.distributed.run`` set ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Backend rule, printed by
rank 0: NCCL when every rank of the host has a card of its own
(``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``); gloo when ranks share
a card (NCCL refuses two ranks on one device) or on the CPU. A backend that
fails to initialise raises: nothing switches backend or device quietly.
Without a launcher there is no process group and ``make_mesh`` gives a
one-rank mesh, as JAX's mesh over one device; a mesh of size 1 is also this
rank alone inside a larger world (``Mesh``), which is how the serial steps
run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device: torch.device, local_world: int) -> Tuple[str, str]:
    """(backend, reason) by the rule of the module doc."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one card a rank"
    return "gloo", f"{local_world} ranks share {cards} card(s); NCCL needs one card a rank"


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the launcher's process group (if the environment names one) and
    return this rank's device: ``cuda:LOCAL_RANK % device_count`` (set as the
    current card) or the CPU. Raises without a card when ``device`` is
    "cuda". Idempotent: a second call returns the device again."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, why = backend_for(dev, local_world)
    if rank == 0:
        print(f"torch.distributed: {world} rank(s), backend {backend} ({why})", flush=True)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return dev


class Mesh:
    """A grid of ranks with named axes. ``shape`` maps each axis to its
    size (JAX's ``Mesh.shape``); ``axis_index(name)`` is this rank's place
    on an axis (JAX's ``lax.axis_index``); ``group(name)`` the process group
    of the ranks that differ from this one only on that axis (None for an
    axis of size 1: collectives over it are the identity).

    A mesh whose axes all have size 1 is this rank alone, in any world (as
    JAX's mesh over one of its devices): it makes no group and every
    collective over it is the identity, so a serial step runs inside a
    multi-rank program. Any other mesh spans the whole world."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        sizes = tuple(self.shape.values())
        glob = dist.get_rank() if dist.is_initialized() else 0
        alone = int(np.prod(sizes)) == 1 or not dist.is_initialized()
        self.world = 1 if alone else dist.get_world_size()
        self.rank = 0 if alone else glob  # this rank's place in the mesh
        if int(np.prod(sizes)) != self.world:
            raise ValueError(f"mesh {sizes} needs {int(np.prod(sizes))} ranks, the world "
                             f"has {self.world}")
        grid = np.arange(self.world).reshape(sizes) + (glob if alone else 0)
        self._coords = dict(zip(self.axis_names,
                                (int(c) for c in np.unravel_index(self.rank, sizes))))
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self._ranks: Dict[str, List[int]] = {}
        for a, name in enumerate(self.axis_names):
            rows = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
            for row in rows:  # every rank creates every group, in the same order
                ranks = [int(r) for r in row]
                g = dist.new_group(ranks) if sizes[a] > 1 else None
                if glob in ranks:
                    self._groups[name], self._ranks[name] = g, ranks

    def size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else self.shape[axis]

    def axis_index(self, axis: Optional[str]) -> int:
        return 0 if axis is None else self._coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups[axis]

    def group_ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in axis order."""
        return list(self._ranks[axis])

    def backend(self) -> Optional[str]:
        return dist.get_backend() if dist.is_initialized() else None


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("batch", "points")) -> Mesh:
    """A mesh over the initialised world (one rank without a process group).
    Default: every rank on the last axis. Raises if the sizes' product is
    neither the world size nor 1 (this rank alone, ``Mesh``). The mesh
    holds no device: the collectives run where their tensors are."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = [1] * (len(axis_names) - 1) + [world]
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} axis names")
    return Mesh(axis_sizes, axis_names)
