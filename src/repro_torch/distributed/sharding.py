"""Logical axis names -> mesh axes (port of ``repro.distributed.sharding``).

Conventions (MaxText-style 2D weight sharding = FSDP x TP):
  * batch        -> ("pod", "data")       (DP across pods and the data axis)
  * d_model rows -> "data"                (FSDP: ZeRO-3-like weight sharding)
  * heads / d_ff / vocab cols -> "model"  (TP)
  * experts      -> "model" when divisible (EP), else 2D TP fallback
  * long-context KV -> "data" when batch < data axis (SP)

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names (one dimension split over several axes, the first major), or
None (replicated); it is ``tuple(PartitionSpec)`` of the reference's,
which writes a one-name tuple as the name.
Meshes are ``launch.mesh.Mesh``: the functions here read only its
``shape`` and ``axis_names``, so they work on an unbound mesh too.

The reference's ``shard`` (``with_sharding_constraint``),
``named_sharding``, ``current_mesh`` and its ``shard_map`` shim are hints
to XLA's partitioner: they change no number, and eager PyTorch has no
compiler to take them, so the port has none.  What stands in for them: a
process group per mesh axis (``launch.mesh.Mesh.group``), the explicit
collectives of ``distributed.comm``, and ``sharding_rules.shard_tree``,
which cuts each leaf to a rank's block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Sequence[str], None]
# A logical axis resolved against a concrete mesh.
Resolved = Union[str, Tuple[str, ...], None]
Spec = Tuple[Resolved, ...]

# Logical name -> preferred mesh axes (first match present in mesh wins; for
# "batch" every present axis is used jointly).
LOGICAL_AXES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "seq": ("data",),      # sequence parallelism for long-context
    "none": (),
}


def resolve_axis(mesh: Any, logical: Axis) -> Resolved:
    """Logical axis name -> mesh axis (or tuple) present in this mesh."""
    if logical is None:
        return None
    if isinstance(logical, (tuple, list)):
        found = tuple(a for a in logical if a in mesh.axis_names)
        return found if found else None
    prefs = LOGICAL_AXES.get(logical, (logical,))
    if logical == "batch":
        found = tuple(a for a in prefs if a in mesh.axis_names)
        return found if found else None
    for a in prefs:
        if a in mesh.axis_names:
            return a
    return None


def canonical(axes: Sequence[Resolved]) -> Spec:
    """``axes`` as a spec, a one-name tuple written as the name (as
    ``PartitionSpec`` writes it)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def make_spec(mesh: Any, *logical_axes: Axis) -> Spec:
    return canonical([resolve_axis(mesh, a) for a in logical_axes])


def axis_size(mesh: Any, axis: Resolved) -> int:
    """The number of blocks ``axis`` splits a dimension into."""
    if axis is None:
        return 1
    names = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(mesh.axis_size(a) for a in names)


def mesh_divides(mesh: Optional[Any], dim: int, logical: Axis) -> bool:
    if mesh is None:
        return False
    axis = resolve_axis(mesh, logical)
    if axis is None:
        return False
    return dim % axis_size(mesh, axis) == 0
