"""Sharding rules of tensor-parallel serving (port of the serve part of
``repro.distributed.sharding_rules``: ``serve_tp_param_spec``,
``serve_tp_cache_spec`` and their tree forms).

Where the reference returns a ``PartitionSpec`` for ``jax.device_put``,
each rule here returns the dimension of the leaf that shards over the
``n`` ranks (an ``int``), or None for a replicated leaf; :func:`shard_tree`
then keeps each rank's slice.  Paths are the port's dotted key paths
(``layers.0.pos0.attn.q_proj.w.planes``, ``0.pos0.k`` in the arena).

For bitwise token identity EVERY sharded projection is N-sharded on its
LAST weight axis (an N-shard never splits a K-reduction; o/down get their
full K through the quantized code gather, ``distributed.tp_serve``), and
everything else (embedding, norms, the head, MoE, SSM) is replicated.
Serve TP is exact-or-error: a sharded axis that does not divide raises.

The training rules (``param_spec``, ``cache_spec``, ``batch_spec``,
``tree_shardings``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels import ops

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


def shard_tree(tree: Any, specs: Dict[str, Spec], *, n: int,
               rank: int) -> Any:
    """``tree`` with every leaf that ``specs`` shards cut to rank
    ``rank``'s slice; replicated leaves are kept as they are."""
    return _map_leaves(tree, lambda path, t: shard(t, specs[path], n=n,
                                                   rank=rank))
