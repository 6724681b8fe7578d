"""The process mesh and its sharding helpers (``rbdtpu.distrib.mesh``) on
``torch.distributed``.

rbdtpu shards the batch of independent problems over a JAX device mesh
and lets XLA insert the collectives.  Here one process drives one device
(a rank), and a ``Mesh`` lays the ranks of the default process group out
on named axes, row-major, like rbdtpu's ``Mesh`` over ``jax.devices()``.
It keeps one process group for every set of its axes, so a reduction over
``axis="batch"`` runs within this rank's row and one over
``("host", "batch")`` over every rank, as rbdtpu's ``psum`` over those
axis names does.

Backends: NCCL on the card; gloo only when the caller asks for the CPU or
for gloo by name.  NCCL drives one card a rank, so ranks that share a card
(more ranks than cards on a host) need gloo, whose collectives then move
their operands through host memory (``distrib.sharded``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..model.robot import RobotModel


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The default process group's ranks on named axes (row-major).

    ``device`` is this rank's device; ``groups`` maps each set of axes
    (a tuple in mesh order) to (the process group of the ranks that share
    this rank's coordinates on the other axes, or None for the default
    group; those ranks, ordered by their index over the set)."""
    axis_names: tuple
    shape: tuple
    rank: int
    world_size: int
    device: torch.device
    backend: str
    groups: dict = dataclasses.field(repr=False)

    def coords(self, rank: Optional[int] = None) -> tuple:
        """The mesh coordinates of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        out = []
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axes(self, axis) -> tuple:
        """An axis name or a tuple of names, checked, as a tuple."""
        ax = axis if isinstance(axis, tuple) else (axis,)
        unknown = [a for a in ax if a not in self.axis_names]
        if unknown or len(set(ax)) != len(ax) or not ax:
            raise ValueError(f"axis {axis!r} is not a set of the mesh's "
                             f"axes {self.axis_names}")
        return ax

    def axis_size(self, axis) -> int:
        """The number of shards over ``axis`` (the product of its sizes)."""
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in self.axes(axis))

    def axis_index(self, axis, rank: Optional[int] = None) -> int:
        """``rank``'s shard index over ``axis``: its coordinates on those
        axes, linearised in the order given (rbdtpu's ``axis_index``)."""
        c = self.coords(rank)
        k = 0
        for a in self.axes(axis):
            i = self.axis_names.index(a)
            k = k * self.shape[i] + c[i]
        return k

    def group(self, axis):
        """(process group, its ranks in group order) of the ranks this rank
        reduces with over ``axis``."""
        ax = self.axes(axis)
        return self.groups[tuple(a for a in self.axis_names if a in ax)]


def _rank_device(device, backend: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU when asked, else card LOCAL_RANK.  Ranks
    beyond the host's cards share them, which only gloo can do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on the card; the CPU needs gloo")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    if dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if local_rank >= n and backend == "nccl":
        raise ValueError(
            f"local rank {local_rank} has no card of its own ({n} visible): "
            "NCCL cannot put two ranks on one card; use backend='gloo'")
    return torch.device("cuda", local_rank % n)


def _init_from_env(backend: str):
    """Start the default process group from the torchrun environment."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"make_mesh: no process group and no torchrun environment "
            f"(missing {missing}); start the ranks with "
            "python -m rbdtpu_torch.distrib.launch or torchrun")
    dist.init_process_group(backend, init_method="env://")


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
    device=None,
    backend: Optional[str] = None,
) -> Mesh:
    """The mesh of every rank of the default process group.

    Uses the initialised default group, or starts one from the torchrun
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) with ``backend``: NCCL for a card, gloo for
    ``device="cpu"`` or when asked by name.  ``device`` None or "cuda"
    gives this rank card ``LOCAL_RANK``.  Default layout: 1-D over every
    rank, named "batch"; pass ``shape`` and ``axis_names`` for 2-D (e.g.
    ("host", "batch")).  ``n_devices`` and ``shape`` must cover the whole
    world: ValueError otherwise."""
    want_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = (dist.get_backend() if dist.is_initialized()
                   else "gloo" if want_cpu else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: unsupported backend {backend!r}")
    if not dist.is_initialized():
        _init_from_env(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks")
    axis_names = tuple(axis_names)
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not lay out {world} ranks")
    dev = _rank_device(device, backend,
                       int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(axis_names, shape, rank, world, dev, backend, {})
    # every rank creates every group, in one order (dist.new_group is
    # collective); the set of all axes is the default group
    for k in range(1, len(axis_names) + 1):
        for sub in itertools.combinations(axis_names, k):
            rows = {}
            for r in range(world):
                other = tuple(c for a, c in zip(axis_names, mesh.coords(r))
                              if a not in sub)
                rows.setdefault(other, []).append(r)
            for ranks in rows.values():
                ranks.sort(key=lambda r: mesh.axis_index(sub, r))
                g = None if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[sub] = (g, tuple(ranks))
    return mesh


def shard_batch(mesh: Mesh, x, axis="batch"):
    """This rank's rows of a batched tensor whose leading dim is sharded
    over ``axis``, on the rank's device.  ValueError when the batch does
    not divide by the number of shards."""
    n, B = mesh.axis_size(axis), x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not divide over {n} shards of "
                         f"axis {axis!r}")
    k, b = mesh.axis_index(axis), B // n
    return x[k * b:(k + 1) * b].to(mesh.device)


def replicate(mesh: Mesh, model: RobotModel) -> RobotModel:
    """The model on this rank's device (every rank holds a full copy)."""
    return model.to(mesh.device)
