"""Convert the JAX package's parameters into the port's layout, so both
packages compute on the same weights.

The input is a numpy tree in the reference's layout — what
``jax.tree.map(np.asarray, params)`` gives — with the period-stacked
``periods`` leaves ([n_periods, ...]) unstacked here into one dict per
layer.  bf16 arrays (numpy has no bf16 of its own) travel through a
``uint16`` view: ``np.asarray(a).view(np.uint16)`` then
``torch.from_numpy(...).view(torch.bfloat16)``, bit for bit.  A prepared
``repro.kernels.ops.QuantizedWeight`` leaf (int8 planes or the uint8
packed store, and the scale) becomes the port's
:class:`~repro_torch.kernels.ops.QuantizedWeight`, so stores prepared by
the two packages can be compared exactly; an MoE projection's keeps its
leading expert axis once the periods are unstacked (planes [E, P, K, N]
or packed [E, K, N], scale [E, 1, N]: the port's expert-stacked store).
SSM leaves (``A_log``, ``dt_bias``, ``D`` in f32; ``conv_w``, ``conv_b``
in bf16) and the f32 router convert as they are.

:func:`stack_layers` goes the other way for trees of tensors (a train
state's params and moments), so train-state checkpoints carry the
reference's leaf names.

This module does not import jax: it receives numpy and recognises a
prepared weight by its fields.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_QW_FIELDS = ("planes", "packed", "scale", "w_bits", "signed", "msb_first")


def to_torch(a: Any, device: Any = None) -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    # ascontiguousarray makes a 0-dim array 1-dim: keep the shape.
    return t.reshape(a.shape).to(resolve_device(device))


def _is_quantized(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _QW_FIELDS)


def _store(qw: Any) -> Any:
    """The array a (reference) QuantizedWeight keeps its codes in."""
    return qw.planes if qw.planes is not None else qw.packed


def _take(tree: Any, i: int) -> Any:
    """Layer ``i`` of a period-stacked tree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if _is_quantized(tree):
        return _QWView(
            None if tree.planes is None else np.asarray(tree.planes)[i],
            None if tree.packed is None else np.asarray(tree.packed)[i],
            np.asarray(tree.scale)[i], tree.w_bits, tree.signed,
            tree.msb_first)
    return np.asarray(tree)[i]


class _QWView:
    """One layer's slice of a stacked reference QuantizedWeight."""

    def __init__(self, planes, packed, scale, w_bits, signed, msb_first):
        self.planes, self.packed, self.scale = planes, packed, scale
        self.w_bits, self.signed, self.msb_first = w_bits, signed, msb_first


def _convert(tree: Any, device: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if _is_quantized(tree):
        return ops.QuantizedWeight(
            planes=None if tree.planes is None
            else to_torch(tree.planes, device),
            packed=None if tree.packed is None
            else to_torch(tree.packed, device),
            scale=to_torch(tree.scale, device), w_bits=int(tree.w_bits),
            signed=bool(tree.signed), msb_first=bool(tree.msb_first))
    return to_torch(tree, device)


def convert_params(params: Dict[str, Any], device: Any = None
                   ) -> Dict[str, Any]:
    """The reference's numpy params tree -> the port's params."""
    out: Dict[str, Any] = {}
    for key, val in params.items():
        if key == "periods":
            first = next(iter(_flat(val)))
            n = np.asarray(_store(first) if _is_quantized(first)
                           else first).shape[0]
            out["layers"] = [_convert(_take(val, i), device) for i in range(n)]
        else:
            out[key] = _convert(val, device)
    return out


def _flat(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree


def stack_layers(tree: Any, device: Any = None) -> Any:
    """The inverse of :func:`convert_params`'s unstacking, for trees of
    tensors: every ``"layers"`` list of per-layer dicts, at any depth (the
    params of a train state and its moments ``m``/``v``), becomes the
    reference's ``"periods"`` dict of leaves stacked along a new leading
    axis ([n_periods, ...]).  Leaves are moved to ``device`` first (None:
    where they are), so a host copy never holds the card's memory twice."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key, val in tree.items():
            if key == "layers" and isinstance(val, list):
                out["periods"] = _stack(val, device)
            else:
                out[key] = stack_layers(val, device)
        return out
    return tree


def _stack(layers: list, device: Any) -> Any:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers], device)
                for k in first}
    return torch.stack([t if device is None else t.to(device)
                        for t in layers])


def unstack_layers(tree: Any) -> Any:
    """Inverse of :func:`stack_layers`: each ``"periods"`` dict becomes a
    ``"layers"`` list of per-layer views of its leaves."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key, val in tree.items():
            if key == "periods":
                n = next(iter(_flat(val))).shape[0]
                out["layers"] = [_index(val, i) for i in range(n)]
            else:
                out[key] = unstack_layers(val)
        return out
    return tree


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
