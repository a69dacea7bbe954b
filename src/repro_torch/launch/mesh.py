"""The walk engine's and the sharded trainer's 1-D world — port of
``repro.launch.mesh``'s ``make_rw_mesh`` and ``make_table_mesh``.

JAX's ``rw`` mesh is one controller's view of every device. Under
``torch.distributed`` every rank runs the program, so an :class:`RwMesh`
is this rank's view: the process group its collectives go through, its
rank, the world's size and the device it computes on. Rank ``r`` owns
vertex rows ``[r·n_local, (r+1)·n_local)`` of the graph and of the
embedding tables, the same ranges JAX gives device ``r``.

The walk meshes and the table meshes go through two groups of their own
(``dist.new_group``), so the walk engine's exchanges and the trainer's
all-reduces never share a stream of collectives. Each group is made once
per role and ranks, the first time a mesh over them is asked for, and
reused by every later mesh of that role under the same default group
(no communicator per engine or trainer). ``new_group`` is collective: every
rank of the default group makes those first calls in the same order.
Without an initialized default
group the mesh is a world of one with no group, where every collective is
the identity (JAX's one-device mesh).

A world of two ranks on one card cannot use NCCL ("Duplicate GPU
detected"); it runs on gloo, one rank per card on NCCL.

The LM dry-run's meshes (``make_production_mesh``, ``make_test_mesh``)
are shapes alone: a :class:`MeshShape` names its axes and their sizes, as
``jax.sharding.Mesh.shape`` does, and touches no device and no process
group. ``launch.sharding`` reads nothing else of a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's shape alone: axis names in order and their sizes.
    ``shape`` is ``{name: size}`` as ``jax.sharding.Mesh.shape``; ``size``
    counts the devices."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for d in self.axis_sizes:
            n *= d
        return n

    @property
    def name(self) -> str:
        """``pod16x16`` / ``pod2x16x16`` for the production meshes."""
        return "pod" + "x".join(str(d) for d in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Production mesh: 16x16 = 256 devices a pod; multi-pod adds a 2-pod
    axis (``pod``, ``data``, ``model``)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> MeshShape:
    """A small mesh shape; ``pod`` adds a leading pod axis."""
    if pod:
        return MeshShape(("pod", "data", "model"), (pod, data, model))
    return MeshShape(("data", "model"), (data, model))


@dataclasses.dataclass(frozen=True)
class RwMesh:
    """This rank's view of a 1-D world: ``group`` is None in a world of
    one without ``torch.distributed``; ``rank`` is -1 on a rank that the
    mesh's group does not hold (``make_table_mesh`` over a prefix)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    ranks: tuple = (0,)         # global ranks of the group, in mesh order

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _device(device) -> torch.device:
    """``resolve_device``, with a bare ``cuda`` pinned to the current card
    (the launcher sets it to ``cuda:LOCAL_RANK``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_GROUPS: dict = {}      # (default group, role, ranks) -> process group


def _group(role: str, ranks: tuple):
    """The ``role`` group over ``ranks``, made on first use under the
    current default group; groups of a destroyed default group are
    forgotten."""
    world = dist.group.WORLD
    for key in [k for k in _GROUPS if k[0] is not world]:
        del _GROUPS[key]
    key = (world, role, ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def _over(role: str, ranks, device) -> RwMesh:
    """A mesh over ``ranks`` of the default group, built by every rank."""
    ranks = tuple(ranks)
    group = _group(role, ranks)
    me = dist.get_rank()
    rank = ranks.index(me) if me in ranks else -1
    return RwMesh(group=group if rank >= 0 else None, rank=rank,
                  size=len(ranks), device=_device(device), ranks=ranks)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_ranks() -> tuple:
    """Global ranks of the default group; ``(0,)`` outside one."""
    if _initialized():
        return tuple(range(dist.get_world_size()))
    return (0,)


def make_rw_mesh(mesh: Optional[RwMesh] = None, device=None) -> RwMesh:
    """The walk engine's mesh: over ``mesh``'s ranks when given, else over
    the default group's; a world of one without ``torch.distributed``."""
    if mesh is not None:
        if device is not None and _device(device) != mesh.device:
            raise ValueError(f"the mesh computes on {mesh.device}, not "
                             f"{device}")
        return mesh
    if not _initialized():
        return RwMesh(group=None, rank=0, size=1, device=_device(device))
    return _over("walk", world_ranks(), device)


def make_table_mesh(mesh: Optional[RwMesh] = None,
                    max_shards: Optional[int] = None, device=None) -> RwMesh:
    """The sharded trainer's mesh, over the same ranks as ``mesh`` (or the
    default group) in the same order, so table shard ``r`` owns the rows
    of graph shard ``r``; ``max_shards`` keeps a prefix of them. Its group
    is not the walk's: its all-reduces never interleave with the walk's
    exchanges."""
    ranks = mesh.ranks if mesh is not None else world_ranks()
    if device is None and mesh is not None:
        device = mesh.device
    if max_shards is not None:
        ranks = ranks[:max_shards]
    if not _initialized():
        return RwMesh(group=None, rank=0, size=1, device=_device(device))
    return _over("table", ranks, device)
