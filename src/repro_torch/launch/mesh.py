"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``):
the training meshes of ``make_mesh`` and ``make_production_mesh``, and
the tensor-parallel serving mesh of ``make_serve_mesh``.

The reference builds a ``jax.sharding.Mesh`` over the devices of ONE
process.  Here every rank is a process of its own (SPMD: each runs the
same program on its shard), started on one host by :func:`spawn_ranks`.
A :class:`Mesh` is an n-dimensional grid of axis names and sizes; bound
to an initialised default group of the same size, it also holds this
rank's coordinates (ranks in row-major order over the grid) and one
process group for its line along each axis (the ranks that differ from it
in that axis only), which the collectives of ``distributed`` run over.
A :class:`ServeMesh` is the 1-D ``("model",)`` mesh of the first ``n``
ranks that ``ServeEngine(mesh=)`` serves on.

The groups' backend follows the topology, and the mesh records it: NCCL
only when every rank has a card of its own; gloo when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU.  Over gloo, CUDA
tensors travel through host memory (``distributed.comm``).  The NCCL
transport has not run yet (one card a machine so far).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import queue
import socket
import traceback
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    TypeVar)

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

T = TypeVar("T")

# A collective that waits this long for a rank that has failed raises
# instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)

# (ranks, backend) -> process group.  ``dist.new_group`` is collective over
# the default group: every rank asks for the same meshes in the same order,
# so each rank's cache holds the same groups.
_GROUPS: Dict[Tuple[Tuple[int, ...], str], Any] = {}


def _group(ranks: Tuple[int, ...], backend: str) -> Any:
    """The process group of ``ranks`` (global ranks), made once.  Every
    rank of the default group must call it for every group, in the same
    order, member or not."""
    key = (ranks, backend)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), backend=backend,
                                      timeout=COLLECTIVE_TIMEOUT)
    return _GROUPS[key]


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The tensor-parallel mesh one rank serves on (the reference's 1-D
    ``("model",)`` mesh): ``group`` holds its ``n`` ranks, ``rank`` is this
    process's place in it (-1 off the mesh, where ``group`` is not usable),
    ``device`` where this rank's shards live and ``backend`` the group's
    transport."""

    group: Any
    n: int
    rank: int
    device: torch.device
    backend: str

    @property
    def member(self) -> bool:
        """True on the ranks that hold a shard."""
        return self.rank >= 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (members only).  The NCCL call
        has not run yet (see :func:`_backend_for`)."""
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _backend_for(devices: List[str]) -> str:
    """NCCL iff every rank has a CUDA device of its own, else gloo.

    Unverified: the NCCL transport (``ServeMesh.barrier``'s ``device_ids``
    and the on-card gathers of ``distributed.tp_serve``) has run on no
    machine with a card for each rank; only gloo has."""
    if all(d.startswith("cuda") for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def make_serve_mesh(n: int, *, device: Any = None) -> ServeMesh:
    """The ``("model",)`` mesh of the first ``n`` ranks of the initialised
    default group (``ServeEngine(mesh=...)`` / ``launch.serve --mesh N``).

    Collective: every rank of the default group calls it (ranks past ``n``
    get a non-member mesh).  ``device`` is this rank's (default: cuda, the
    current card).  Raises if the default group is not initialised or has
    fewer than ``n`` ranks."""
    if n < 1:
        raise ValueError(f"--mesh {n}: a mesh needs at least one rank")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"--mesh {n} needs an initialised torch.distributed default "
            "group of at least that many ranks (start them with "
            "repro_torch.launch.mesh.spawn_ranks)")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"--mesh {n} needs {n} ranks but the default "
                         f"group has only {world}")
    dev, devices = _rank_devices(device)
    backend = _backend_for(devices[:n])
    rank = dist.get_rank()
    return ServeMesh(group=_group(tuple(range(n)), backend), n=n,
                     rank=rank if rank < n else -1, device=dev,
                     backend=backend)


def _rank_devices(device: Any) -> Tuple[torch.device, List[str]]:
    """This rank's device (default: cuda, the current card) and every
    rank's, by name, in rank order (collective)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(dev))
    return dev, [str(d) for d in devices]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n-dimensional mesh: ``shape`` and ``axis_names`` (the
    reference's ``mesh.devices.shape`` and ``mesh.axis_names``), which is
    all the sharding rules read.  Bound (``rank >= 0``) it is one rank's
    view of the default group laid out row-major over ``shape``: its
    ``device``, the groups' ``backend`` and, per axis, the process group
    of its line along that axis (``group``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = -1
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    groups: Tuple[Any, ...] = dataclasses.field(default=(), compare=False,
                                                repr=False)

    @property
    def n(self) -> int:
        """The number of ranks (devices) of the mesh."""
        return math.prod(self.shape)

    @property
    def bound(self) -> bool:
        return self.rank >= 0

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        """Rank ``rank``'s place on each axis (row-major)."""
        return tuple(int(i) for i in np.unravel_index(rank, self.shape))

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's place on each axis."""
        if not self.bound:
            raise ValueError("an unbound mesh has no ranks")
        return self.coords_of(self.rank)

    def index(self, name: str) -> int:
        """This rank's place on axis ``name`` (its rank in
        ``group(name)``)."""
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str) -> Any:
        """The process group of this rank's line along axis ``name``."""
        if not self.bound:
            raise ValueError("an unbound mesh has no process groups")
        return self.groups[self.axis_names.index(name)]

    def barrier(self) -> None:
        """Wait for every rank of the mesh (the default group)."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _lines(shape: Tuple[int, ...], axis: int) -> List[Tuple[int, ...]]:
    """The ranks of every line along ``axis`` (row-major ranks), each in
    axis order, the lines in row-major order of the other axes."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    moved = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
    return [tuple(int(r) for r in line) for line in moved]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Any = None) -> Mesh:
    """The mesh ``shape`` x ``axes`` over the initialised default group,
    whose size must be the mesh's (e.g. ``(4,), ("stage",)`` or ``(2, 2),
    ("data", "model")``).

    Collective: every rank of the default group calls it, and makes every
    line's group in the same order.  ``device`` is this rank's (default:
    cuda, the current card).  Raises if the default group is not
    initialised or its size is not the mesh's."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a {shape} mesh needs an initialised torch.distributed default "
            f"group of {n} ranks (start them with "
            "repro_torch.launch.mesh.spawn_ranks)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks but the default "
                         f"group has {world}")
    dev, devices = _rank_devices(device)
    backend = _backend_for(devices)
    rank = dist.get_rank()
    groups = []
    for axis in range(len(shape)):
        mine = None
        for line in _lines(shape, axis):
            g = _group(line, backend)
            if rank in line:
                mine = g
        groups.append(mine)
    return Mesh(shape=shape, axis_names=axes, rank=rank, device=dev,
                backend=backend, groups=tuple(groups))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: one pod of 16 x 16 = 256 chips
    ``("data", "model")``, or two pods, 2 x 16 x 16 = 512 chips ``("pod",
    "data", "model")`` with DP across pods.  No machine here has 256
    ranks, so the mesh is returned unbound: its shape and axis names are
    what the sharding rules read (the reference's dry-run does no more
    with it either)."""
    if multi_pod:
        return Mesh(shape=(2, 16, 16), axis_names=("pod", "data", "model"))
    return Mesh(shape=(16, 16), axis_names=("data", "model"))


def in_turn(mesh: Any, fn: Callable[[], T]) -> T:
    """``fn()`` on each rank of ``mesh`` (a :class:`ServeMesh` or a bound
    :class:`Mesh`) in rank order, one rank at a time (a barrier after each
    turn): e.g. each rank building the full store before keeping its
    shard, so that no two full stores are ever on one card together.
    Returns this rank's result."""
    out: Any = None
    for r in range(mesh.n):
        if r == mesh.rank:
            out = fn()
        mesh.barrier()
    return out


class RankError(RuntimeError):
    """A rank of :func:`spawn_ranks` failed; the message holds its
    traceback."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _rank_main(rank: int, n: int, port: int, device: str, fn: Callable,
               args: Tuple[Any, ...], results: Any) -> None:
    """One spawned rank: pin its device (or one intra-op thread on the
    CPU), join the group, run ``fn(rank, *args)`` and report."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank if torch.cuda.device_count() >= n
                                  else 0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:           # reported, then the caller raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(n: int, fn: Callable[..., T], *args: Any,
                device: str = "cuda") -> List[T]:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes (``spawn``) that
    form a ``torch.distributed`` default group (gloo, rendezvous at
    ``tcp://127.0.0.1`` on a free port).  On the CPU each rank runs one
    intra-op thread; on ``cuda`` rank ``r`` takes card ``r`` when there
    are ``n`` cards, else they all share card 0.  ``fn`` must be importable
    by name (a module-level function) and return picklable values.

    Returns the ranks' results in rank order.  A rank that raises (or
    dies) ends every rank and raises :class:`RankError` here with its
    traceback: no rank's failure is carried on."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, device, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failure: Optional[str] = None
    try:
        while len(out) < n and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                continue
            if ok:
                out[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
        results.close()
    if failure is not None:
        raise RankError(failure)
    return [out[r] for r in range(n)]
