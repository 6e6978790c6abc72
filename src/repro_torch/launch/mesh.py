"""Meshes for tensor-parallel serving over ``torch.distributed`` (port of
``repro.launch.mesh.make_serve_mesh``).

The reference builds a 1-D ``("model",)`` ``jax.sharding.Mesh`` over the
first ``n`` devices of ONE process.  Here every rank is a process of its
own (SPMD: each runs the same engine on its shard), so a mesh is the
process group of the first ``n`` ranks of an initialised default group,
with this process's place in it.  :func:`spawn_ranks` starts such a group
on one host.

The group's backend follows the topology, and the mesh records it: NCCL
only when every rank has a card of its own; gloo when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU.  Over gloo, CUDA
tensors travel through host memory (``distributed.tp_serve``).  The NCCL
transport has not run yet (one card a machine so far).

The reference's ``make_mesh`` and ``make_production_mesh`` (training
meshes) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

T = TypeVar("T")

# A collective that waits this long for a rank that has failed raises
# instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)

# (n, backend) -> process group.  ``dist.new_group`` is collective over the
# default group: every rank asks for the same meshes in the same order, so
# each rank's cache holds the same groups.
_GROUPS: Dict[Tuple[int, str], Any] = {}


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
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices: List[Optional[str]] = [None] * world
    dist.all_gather_object(devices, str(dev))
    backend = _backend_for([str(d) for d in devices[:n]])
    key = (n, backend)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(range(n)), backend=backend,
                                      timeout=COLLECTIVE_TIMEOUT)
    rank = dist.get_rank()
    return ServeMesh(group=_GROUPS[key], n=n, rank=rank if rank < n else -1,
                     device=dev, backend=backend)


def in_turn(mesh: ServeMesh, fn: Callable[[], T]) -> T:
    """``fn()`` on each rank of ``mesh`` in rank order, one rank at a time
    (a barrier after each turn): e.g. each rank building the full store
    before keeping its shard, so that no two full stores are ever on one
    card together.  Returns this rank's result."""
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
