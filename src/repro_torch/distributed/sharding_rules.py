"""Sharding rules (port of ``repro.distributed.sharding_rules``): the
training rules of the production mesh, and the rules of tensor-parallel
serving.

**Training** (``param_spec``, ``tree_shardings``, ``batch_spec``,
``cache_spec`` and their tree forms): 2D weight sharding (FSDP over
"data" x TP over "model"), EP for expert weights when the expert count
divides the model axis, replication for vectors.  Each returns a spec
(``distributed.sharding``: one entry per dimension, an axis name, a tuple
of names or None); the tree forms return ``{dotted path: spec}``.  A
training axis that does not divide its dimension is dropped for that
dimension.  The rules match on dotted key paths (first match wins), the
reference's ``keystr`` suffixes written with dots
(``['q_proj']['w']`` -> ``.q_proj.w.``).  The reference stacks the
periods of its trees along a leading axis; the port keeps a list with one
entry per period (``layers.0.pos0.attn.q_proj.w``, an arena's
``0.pos0.k``).  A leaf under such a list index gets the reference's spec
of the stacked leaf without its leading period entry; a stacked tree
(``convert.stack_layers``, a train-state checkpoint) gets the
reference's spec as it is.  :func:`shard_tree` with a mesh keeps a
rank's block of every leaf by its coordinates, :func:`gather_tree` puts
the whole back from every rank's blocks.

**Serving** (``serve_tp_param_spec``, ``serve_tp_cache_spec`` and their
tree forms): where the reference returns a ``PartitionSpec`` for
``jax.device_put``, each rule here returns the dimension of the leaf that
shards over the ``n`` ranks (an ``int``), or None for a replicated leaf;
:func:`shard_tree` then keeps each rank's slice.  Paths are the port's
dotted key paths (``layers.0.pos0.attn.q_proj.w.planes``, ``0.pos0.k`` in
the arena).  For bitwise token identity EVERY sharded projection is
N-sharded on its LAST weight axis (an N-shard never splits a
K-reduction; o/down get their full K through the quantized code gather,
``distributed.tp_serve``), and everything else (embedding, norms, the
head, MoE, SSM) is replicated.  Serve TP is exact-or-error: a sharded
axis that does not divide raises.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (Resolved, axis_size,
                                              canonical, resolve_axis)
from repro_torch.distributed.sharding import Spec as MeshSpec
from repro_torch.kernels import ops

# -------------------------------------------------------------- training
# Trailing-dim logical spec: logical axis name (or None) per dim.
_Logical = Tuple[Optional[str], ...]

# (dotted path part, logical spec for the trailing dims).  First match
# wins.  Leading dims (the stacked period dim, a plane dim) are padded
# with None.
_RULES: Tuple[Tuple[str, _Logical], ...] = (
    # MoE expert banks [E, d, f] / [E, f, d]: EP on E (checked divisible),
    # FSDP on the middle dim.
    (".moe.gate_proj.w.", ("expert", "fsdp", None)),
    (".moe.up_proj.w.", ("expert", "fsdp", None)),
    (".moe.down_proj.w.", ("expert", "fsdp", None)),
    (".moe.router.w.", (None, None)),
    # Attention / MLP projections [in, out].
    (".q_proj.w.", ("fsdp", "model")),
    (".k_proj.w.", ("fsdp", "model")),
    (".v_proj.w.", ("fsdp", "model")),
    (".o_proj.w.", ("model", "fsdp")),
    (".gate_proj.w.", ("fsdp", "model")),
    (".up_proj.w.", ("fsdp", "model")),
    (".down_proj.w.", ("model", "fsdp")),
    # SSM projections.
    (".in_proj.w.", ("fsdp", "model")),
    (".out_proj.w.", ("model", "fsdp")),
    # Embedding / head.
    (".embed.emb.", ("model", "fsdp")),
    (".lm_head.w.", ("fsdp", "model")),
)

_MOE_TP_FALLBACK: Dict[str, _Logical] = {
    ".moe.gate_proj.w.": (None, "fsdp", "model"),
    ".moe.up_proj.w.": (None, "fsdp", "model"),
    ".moe.down_proj.w.": (None, "model", "fsdp"),
}


def _per_layer(path: str) -> bool:
    """True for a leaf under a per-period list index (``layers.3.``, an
    arena's ``0.pos0.k``): the reference's leaf has a period dim more."""
    return any(part.isdigit() for part in path.split("."))


def _as_stacked(spec_fn: Callable[[Any, str, Tuple[int, ...]], MeshSpec],
                mesh: Any, path: str, leaf: Any) -> MeshSpec:
    """``spec_fn`` on the reference's shape of ``leaf``: a per-layer leaf
    is stacked over one period and the period's entry dropped."""
    shape = tuple(leaf.shape)
    if _per_layer(path):
        return spec_fn(mesh, path, (1,) + shape)[1:]
    return spec_fn(mesh, path, shape)


def _param_spec(mesh: Any, path: str, shape: Tuple[int, ...]) -> MeshSpec:
    key = "." + path + "."
    is_planes = path.endswith(".planes")   # QuantizedWeight planes [..,P,K,N]
    for suffix, logical in _RULES:
        if suffix not in key:
            continue
        # EP fallback: experts must divide the model axis.
        if suffix in _MOE_TP_FALLBACK:
            e = shape[-4] if is_planes else shape[-3]
            model = mesh.axis_size("model") \
                if "model" in mesh.axis_names else 1
            if e % model != 0:
                logical = _MOE_TP_FALLBACK[suffix]
        if is_planes and len(logical) == 3:
            # Keep E on the expert dim; plane dim P replicated.
            logical = (logical[0], None) + tuple(logical[1:])
        lead = len(shape) - len(logical)
        axes = (None,) * lead + tuple(resolve_axis(mesh, a)
                                      for a in logical)
        # Drop annotations that do not divide.
        return canonical([a if a is not None
                          and shape[i] % axis_size(mesh, a) == 0 else None
                          for i, a in enumerate(axes)])
    return (None,) * len(shape)   # vectors / norms / biases: replicated


def param_spec(mesh: Any, path: str, leaf: Any) -> MeshSpec:
    """The spec of one parameter (or optimizer-moment) leaf at dotted
    ``path``: float weights, prepared planes, packed codes and scales."""
    return _as_stacked(_param_spec, mesh, path, leaf)


def leaf_paths(tree: Any) -> Dict[str, Any]:
    """{dotted path: leaf} over every tensor of ``tree``."""
    out: Dict[str, Any] = {}
    _map_leaves(tree, lambda path, t: out.setdefault(path, t))
    return out


def tree_shardings(mesh: Any, tree: Any) -> Dict[str, MeshSpec]:
    """{dotted path: spec} for params / optimizer state."""
    return {path: param_spec(mesh, path, leaf)
            for path, leaf in leaf_paths(tree).items()}


def batch_spec(mesh: Any, shape: Sequence[int]) -> MeshSpec:
    """Batch sharded over (pod, data) when divisible; else replicated
    (e.g. long-context global_batch=1)."""
    ndim = len(shape)
    batch_axes = resolve_axis(mesh, "batch")
    if batch_axes is None or shape[0] % axis_size(mesh, batch_axes) != 0:
        return (None,) * ndim
    return canonical((batch_axes,) + (None,) * (ndim - 1))


def batch_shardings(mesh: Any, batch: Any) -> Dict[str, MeshSpec]:
    """{dotted path: spec} over a batch's tensors."""
    return {path: batch_spec(mesh, tuple(leaf.shape))
            for path, leaf in leaf_paths(batch).items()}


def _cache_spec(mesh: Any, path: str, shape: Tuple[int, ...]) -> MeshSpec:
    ndim = len(shape)
    if ndim < 4:
        return (None,) * ndim
    batch_axes = resolve_axis(mesh, "batch")
    model = resolve_axis(mesh, "model")
    axes: List[Resolved] = [None] * ndim
    if batch_axes is not None \
            and shape[1] % axis_size(mesh, batch_axes) == 0:
        axes[1] = batch_axes

    def try_axis(dim: int, ax: Resolved) -> None:
        if ax is not None and shape[dim] % axis_size(mesh, ax) == 0:
            axes[dim] = ax

    leafname = path.rsplit(".", 1)[-1]
    if leafname in ("k", "v"):
        # [periods, B, S, KVH, Dh]: TP over KV heads when they divide the
        # model axis, else over head_dim; SP over S if the batch could not
        # shard (long-context, batch=1).
        try_axis(3, model)
        if axes[3] is None:
            try_axis(4, model)
        if axes[1] is None:
            try_axis(2, resolve_axis(mesh, "seq"))
    elif leafname in ("k_scale", "v_scale"):
        # [periods, B, S, KVH, 1]: follow the KV head sharding.
        try_axis(3, model)
        if axes[1] is None:
            try_axis(2, resolve_axis(mesh, "seq"))
    elif leafname == "state":
        try_axis(2, model)        # [periods, B, H, N, P]: TP over SSM heads
    elif leafname == "conv":
        try_axis(3, model)        # [periods, B, W, C]: TP over channels
    return canonical(axes)


def cache_spec(mesh: Any, path: str, leaf: Any) -> MeshSpec:
    """KV/SSM caches: batch axis sharded (dim 1 after the stacked period
    dim 0); KV / SSM heads sharded over model when divisible; long-context
    KV falls back to sequence sharding (SP) when the batch does not
    divide."""
    return _as_stacked(_cache_spec, mesh, path, leaf)


def cache_shardings(mesh: Any, caches: Any) -> Dict[str, MeshSpec]:
    """{dotted path: spec} over a model's caches."""
    return {path: cache_spec(mesh, path, leaf)
            for path, leaf in leaf_paths(caches).items()}


def _block_slices(shape: Sequence[int], spec: MeshSpec, mesh: Any,
                  coords: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slices of the block that the rank at ``coords`` holds."""
    place = dict(zip(mesh.axis_names, coords))
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        n = axis_size(mesh, axis)
        if shape[dim] % n != 0:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not "
                             f"split over {axis} ({n} blocks)")
        index = 0
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            index = index * mesh.axis_size(a) + place[a]
        size = shape[dim] // n
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def block(t: Any, spec: MeshSpec, mesh: Any) -> Any:
    """This rank's block of ``t`` (a tensor or a numpy array) under
    ``spec``, as a contiguous copy."""
    part = t[_block_slices(t.shape, spec, mesh, mesh.coords)]
    if isinstance(part, torch.Tensor):
        return part.clone(memory_format=torch.contiguous_format)
    return np.array(part, order="C")


def gather_tree(blocks: Sequence[Any], specs: Dict[str, MeshSpec],
                mesh: Any) -> Any:
    """The whole tree from every rank's blocks (``blocks[r]`` the tree of
    rank ``r``, as :func:`shard_tree` with ``mesh`` cut it)."""
    per_rank = [leaf_paths(b) for b in blocks]
    if len(per_rank) != mesh.n:
        raise ValueError(f"{len(per_rank)} block trees for a mesh of "
                         f"{mesh.n} ranks")

    def whole(path: str, first: torch.Tensor) -> torch.Tensor:
        spec = specs[path]
        shape = [s * axis_size(mesh, a) for s, a in zip(first.shape, spec)]
        out = first.new_empty(shape)
        for r, leaves in enumerate(per_rank):
            out[_block_slices(shape, spec, mesh, mesh.coords_of(r))] = \
                leaves[path]
        return out
    return _map_leaves(blocks[0], whole)


def block_bytes(tree: Any, specs: Dict[str, MeshSpec], mesh: Any) -> int:
    """The bytes of ``tree`` that one rank holds under ``specs``: each
    leaf's bytes over the number of blocks its spec cuts it into (a
    reckoning from shapes; meta tensors will do)."""
    total = 0
    for path, leaf in leaf_paths(tree).items():
        blocks = math.prod(axis_size(mesh, a) for a in specs[path])
        total += leaf.numel() * leaf.element_size() // blocks
    return total


def dotted_path(keystr: str) -> str:
    """A ``jax.tree_util.keystr`` path (a checkpoint's leaf names,
    ``['params']['periods']['pos0']['attn']['q_proj']['w']``) in the
    dotted form the rules match."""
    parts = re.findall(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)", keystr)
    return ".".join(next(p for p in groups if p) for groups in parts)


def restore_block_fn(mesh: Any) -> Callable[[str, np.ndarray], np.ndarray]:
    """``checkpoint.restore``'s ``sharding_fn`` that keeps this rank's
    block of every leaf of a train state (``{"params", "opt"}``) under
    the training rules."""
    return lambda path, arr: block(
        arr, param_spec(mesh, dotted_path(path), arr), mesh)


# --------------------------------------------------------------- serve TP
_SERVE_TP_SHARDED = (".attn.q_proj.", ".attn.o_proj.", ".mlp.gate_proj.",
                     ".mlp.up_proj.", ".mlp.down_proj.")
_SERVE_TP_KV = (".attn.k_proj.", ".attn.v_proj.")
_KV_FIELDS = ("k", "v", "k_scale", "v_scale")

Spec = Optional[int]


def serve_tp_param_spec(path: str, leaf: Any, *, n: int,
                        kv_shards: bool) -> Spec:
    """The sharded dimension of one prepared (QuantizedWeight) leaf: the
    last axis of ``planes`` / ``packed`` / ``scale`` of the TP projections
    (k/v only when ``kv_shards``), else None.  Raises if that axis does not
    divide across ``n`` ranks."""
    if not path.endswith((".planes", ".packed", ".scale")):
        return None
    names = _SERVE_TP_SHARDED + (_SERVE_TP_KV if kv_shards else ())
    if not any(s in "." + path for s in names):
        return None
    if leaf.shape[-1] % n != 0:
        raise ValueError(
            f"serve TP: {path} last axis {leaf.shape[-1]} does not divide "
            f"across {n} devices")
    return leaf.ndim - 1


def serve_tp_cache_spec(path: str, leaf: Any, *, n: int,
                        kv_shards: bool) -> Spec:
    """The sharded dimension of one KV cache leaf (``[..., KVH, lanes]``:
    an arena's [B, S, KVH, L], a snapshot stacked over periods [P, 1, S,
    KVH, L]): k/v lanes and their scales shard over KV heads when
    ``kv_shards``; lengths, tier codes and SSM state stay replicated."""
    leafname = path.rsplit(".", 1)[-1]
    if kv_shards and leaf.ndim >= 4 and leafname in _KV_FIELDS:
        axis = leaf.ndim - 2
        if leaf.shape[axis] % n != 0:
            raise ValueError(
                f"serve TP: {path} KV-head axis {leaf.shape[axis]} does not "
                f"divide across {n} devices")
        return axis
    return None


def _map_leaves(tree: Any, fn: Callable[[str, torch.Tensor], Any],
                path: str = "") -> Any:
    """``tree`` (dicts, lists, QuantizedWeights, caches with ``FIELDS``)
    with every tensor leaf replaced by ``fn(its dotted path, leaf)``."""
    def join(key: Any) -> str:
        return f"{path}.{key}" if path else str(key)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, join(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, join(i)) for i, v in enumerate(tree)]
    if isinstance(tree, ops.QuantizedWeight):
        fields = ("planes", "packed", "scale")
    elif hasattr(tree, "FIELDS") and dataclasses.is_dataclass(tree):
        fields = tree.FIELDS
    elif isinstance(tree, torch.Tensor):
        return fn(path, tree)
    else:
        return tree
    return dataclasses.replace(tree, **{
        f: fn(join(f), getattr(tree, f)) for f in fields
        if getattr(tree, f) is not None})


def _specs(tree: Any, spec_fn: Callable[..., Spec], *, n: int,
           kv_shards: bool) -> Dict[str, Spec]:
    out: Dict[str, Spec] = {}

    def record(path: str, leaf: torch.Tensor) -> torch.Tensor:
        out[path] = spec_fn(path, leaf, n=n, kv_shards=kv_shards)
        return leaf
    _map_leaves(tree, record)
    return out


def serve_tp_param_specs(tree: Any, *, n: int,
                         kv_shards: bool) -> Dict[str, Spec]:
    """{dotted path: sharded dimension or None} over every tensor of the
    prepared superplane store."""
    return _specs(tree, serve_tp_param_spec, n=n, kv_shards=kv_shards)


def serve_tp_cache_specs(tree: Any, *, n: int,
                         kv_shards: bool) -> Dict[str, Spec]:
    """{dotted path: sharded dimension or None} over every tensor of the
    slot arena's caches."""
    return _specs(tree, serve_tp_cache_spec, n=n, kv_shards=kv_shards)


def shard(t: torch.Tensor, dim: Spec, *, n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (a copy, so the whole
    tensor can be freed); ``t`` itself where ``dim`` is None."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree: Any, specs: Dict[str, Any], *, n: int = 1,
               rank: int = 0, mesh: Any = None) -> Any:
    """``tree`` with every leaf that ``specs`` shards cut to one rank's
    part.  With ``mesh`` (a bound ``launch.mesh.Mesh``), ``specs`` are the
    training rules' (:func:`tree_shardings`) and each leaf becomes this
    rank's block by its coordinates; without, they are the serve rules'
    (a dimension or None) and rank ``rank`` of ``n`` keeps its slice.
    Replicated leaves are kept as they are."""
    if mesh is not None:
        return _map_leaves(tree, lambda path, t: t if all(
            a is None for a in specs[path]) else block(t, specs[path], mesh))
    return _map_leaves(tree, lambda path, t: shard(t, specs[path], n=n,
                                                   rank=rank))
