"""The collectives every distributed module of the port moves tensors with,
over ``torch.distributed`` process groups (a mesh axis's line of ranks,
``launch.mesh``).

A gloo group moves CPU tensors only, so a CUDA tensor on a gloo group is
staged through host memory explicitly (``.cpu()``, the collective,
``.to(device)``): the transport of ranks that share one card, where NCCL
refuses to run.  An NCCL group moves the card's tensors directly (not run
yet: ``launch.mesh._backend_for``).  Each function returns a new tensor
on the input's device and leaves its input unchanged.

Where a sum's rounding matters, the sum is taken here, in rank order, and
not by the transport (whose reduction order is its own):
:func:`reduce_scatter_ordered` moves the parts with an all-to-all and adds
them one rank after another in the parts' dtype, so the card and the CPU
round the same way.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group: Any) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send_form(t: torch.Tensor, group: Any) -> torch.Tensor:
    """A contiguous copy of ``t`` that the group's transport can move."""
    return (t.cpu() if _staged(t, group) else t.clone()).contiguous()


def all_gather_tiled(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (a tiled
    all-gather)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _send_form(t, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_reduce(t: torch.Tensor, group: Any,
               op: Any = dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the group, elementwise.  Exact for MAX and for integer
    sums; a float sum is reduced in the transport's order."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    buf = _send_form(t, group)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def reduce_scatter_ordered(t: torch.Tensor, dim: int,
                           group: Any) -> torch.Tensor:
    """The group's sum of ``t``, split into n blocks along ``dim``; this
    rank keeps its block (a tiled reduce-scatter).  The n parts of the
    block are added in rank order, each addition rounded to ``t``'s
    dtype."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    blocks = torch.stack(t.chunk(n, dim=dim))       # [n, ...block]
    src = _send_form(blocks, group)
    parts = torch.empty_like(src)
    dist.all_to_all_single(parts, src, group=group)
    parts = parts.to(t.device)
    acc = parts[0]
    for r in range(1, n):
        acc = acc + parts[r]
    return acc


def broadcast(t: torch.Tensor, src: int, group: Any) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of the group (``t`` gives
    the shape and dtype elsewhere)."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    buf = _send_form(t, group)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.device)


def gather(t: torch.Tensor, dst: int, group: Any
           ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (the same shape on every rank), in rank order, on
    group rank ``dst`` (on the host when staged); None elsewhere."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    src = _send_form(t, group)
    me = dist.get_rank(group)
    parts = [torch.empty_like(src) for _ in range(n)] if me == dst else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, dst),
                group=group)
    return parts


def exchange(send: Optional[torch.Tensor], to: Optional[int],
             recv_like: Optional[torch.Tensor], frm: Optional[int],
             group: Any) -> Optional[torch.Tensor]:
    """Send ``send`` to group rank ``to`` and receive a tensor shaped like
    ``recv_like`` from group rank ``frm`` (either side may be None).  The
    send is posted first and does not block, so a chain of ranks that each
    send forward and receive from behind never waits on itself."""
    work = None
    if send is not None:
        work = dist.isend(_send_form(send, group),
                          dst=dist.get_global_rank(group, to), group=group)
    out = None
    if recv_like is not None:
        buf = torch.empty_like(recv_like, device="cpu") \
            if _staged(recv_like, group) else torch.empty_like(recv_like)
        dist.recv(buf, src=dist.get_global_rank(group, frm), group=group)
        out = buf.to(recv_like.device)
    if work is not None:
        work.wait()
    return out
