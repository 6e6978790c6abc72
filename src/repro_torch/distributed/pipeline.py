"""Pipeline parallelism: GPipe-style microbatched execution over a "stage"
mesh axis, over ``torch.distributed`` (port of
``repro.distributed.pipeline``).

Every rank of the axis is one stage (SPMD, ``launch.mesh``) and runs the
reference's schedule: ``n_micro + n_stages - 1`` ticks; at tick t stage s
holds microbatch t - s, stage 0 injecting it from the input, the last
stage banking its output, and each stage's output going to stage s + 1
(the reference's ``ppermute``).  A stage computes only on the ticks where
it holds a microbatch: the reference's SPMD loop also runs every stage
on the other (bubble) ticks, on zeros or stale activations, and never
banks what they give, so no output changes.  Sends are posted before the
blocking receives (``comm.exchange``), so no rank waits on itself.

:func:`run_pipeline` returns the last stage's outputs on every stage by a
broadcast, which keeps their bits; the reference's masked ``psum`` does
the same up to the sign of a zero (-0.0 comes back as +0.0 there).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.distributed import comm

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def gpipe(stage_fn: StageFn, *, mesh: Any,
          axis_name: str = "stage") -> StageFn:
    """Build a pipelined forward for ``y = stage_{S-1}(... stage_0(x))``.

    stage_fn(stage_params, x) -> y must be shape-preserving ([mb, ...] ->
    same), and is executed with this rank's stage parameters.

    Returns pipe(stage_params_local, x_micro [n_micro, mb, ...]), which
    every rank of the mesh's ``axis_name`` line calls: each sees all
    microbatches, computes only its stage, and activations flow stage ->
    stage + 1.  Output: [n_micro, mb, ...], valid on the last stage
    (zeros elsewhere)."""

    def pipe(stage_params: Any, x_micro: torch.Tensor) -> torch.Tensor:
        n_stages = mesh.axis_size(axis_name)
        stage = mesh.index(axis_name)
        group = mesh.group(axis_name)
        n_micro = x_micro.shape[0]

        def holds(s: int, t: int) -> bool:
            return 0 <= t - s < n_micro

        buf = torch.zeros_like(x_micro)                 # banked outputs
        carry = None                                    # inbound activation
        for t in range(n_micro + n_stages - 1):
            y = None
            if holds(stage, t):
                x_in = x_micro[t - stage] if stage == 0 else carry
                y = stage_fn(stage_params, x_in)
                if stage == n_stages - 1:
                    buf[t - stage] = y
            # Ship activations to the next stage.
            send = y is not None and stage < n_stages - 1
            recv = stage > 0 and holds(stage - 1, t)
            carry = comm.exchange(y if send else None, stage + 1,
                                  x_micro[0] if recv else None, stage - 1,
                                  group)
        return buf

    return pipe


def run_pipeline(mesh: Any, stage_fn: StageFn, stage_params: Sequence[Any],
                 x_micro: torch.Tensor,
                 axis_name: str = "stage") -> torch.Tensor:
    """The pipelined forward on every rank of the mesh's ``axis_name``.

    stage_params: indexed by stage (a list with one entry per stage, or
    a tensor with a leading stage dim); x_micro: [n_micro, mb, ...], the
    same on every rank.  Returns the last stage's outputs, on every
    rank."""
    stage = mesh.index(axis_name)
    out = gpipe(stage_fn, mesh=mesh, axis_name=axis_name)(
        stage_params[stage], x_micro)
    return comm.broadcast(out, mesh.axis_size(axis_name) - 1,
                          mesh.group(axis_name))
