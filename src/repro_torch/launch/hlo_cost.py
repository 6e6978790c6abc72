"""Cost analysis of an eager step over its dispatched torch ops (port of
``repro.launch.hlo_cost``).

The reference walks the optimized HLO text of a compiled step.  Torch has
no HLO, so the port runs the step itself under a ``TorchDispatchMode``
(:class:`CostMode`) and counts every ATen op that reaches the dispatcher,
after autograd (the backward's ops included).  Run on ``meta`` tensors it
allocates nothing, so full-size configs cost host time only.

Conventions:
  * flops: ``torch.utils.flop_counter``'s formulas (its registry) for
    matmuls, batched matmuls (einsum's lowering), convolutions and
    attention, counted as ``FlopCounterMode`` counts them; elementwise ops
    count none.  These are the reference's ``dot`` / ``convolution``.
  * loops: an eager Python loop dispatches its body once per trip, so the
    flash-attention K/V blocks and the SSD chunks are counted trip by trip
    with no special handling (the reference scales a while body by its
    trip count).
  * bytes = operand + result bytes of every op.  Eager torch has no
    fusion, so every op is a top-level op and the bytes are an upper bound
    on what fused kernels would move.  Views are free; an operand is
    charged the bytes its strides reach (a broadcast dimension once); the
    in-place updates ``copy_`` / ``index_put_`` / ``index_copy_`` are
    charged twice their update's bytes (read + write of the region), as
    the reference charges ``dynamic-update-slice``.
  * collective operand bytes: all-gather result/g, reduce-scatter
    result*g, others = result bytes.  An eager step on one device has no
    collectives; the dry-run adds them to a :class:`Cost` from the
    sharding rules (``launch.dryrun``).
  * live bytes: every storage an op creates is live from that op until
    it is freed (a ``weakref.finalize`` on the storage, which outlives a
    tensor saved for the backward); :attr:`CostMode.peak_bytes` is the
    highest sum over the step, the step's outputs included.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# Metadata queries that FlopCounterMode lets through uncounted.
_QUERIES = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
            _aten.is_contiguous.memory_format,
            _aten.is_strides_like_format.default,
            _aten.is_non_overlapping_and_dense.default,
            _aten.size.default, _aten.sym_size.default,
            _aten.stride.default, _aten.sym_stride.default,
            _aten.storage_offset.default, _aten.sym_storage_offset.default,
            _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
            torch.ops.prim.layout.default}
# Ops that return a view of their input without saying so in the schema.
_VIEWS = {_aten._unsafe_view.default}
# In-place updates -> the argument that holds the update.
_UPDATES = {_aten.copy_: 1, _aten.index_put_: 2, _aten._index_put_impl_: 2,
            _aten.index_copy_: 3}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    # f32 share of collective bytes (the reference tracks it because
    # XLA:CPU promotes bf16 dot operands to f32; here it is the f32 leaves'
    # share).
    coll_bytes_f32: float = 0.0

    def add_collective(self, op: str, result_bytes: float, group: int, *,
                       f32: bool = False) -> None:
        """One collective ``op`` whose result is ``result_bytes`` over a
        group of ``group`` devices, by the operand-bytes convention."""
        if op == "all-gather":
            obytes = result_bytes / group
        elif op == "reduce-scatter":
            obytes = result_bytes * group
        else:
            obytes = result_bytes
        self.coll_bytes[op] += obytes
        self.coll_counts[op] += 1
        if f32:
            self.coll_bytes_f32 += obytes

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def as_dict(self) -> Dict[str, object]:
        """The reference's ``analyze`` result."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collectives": {
                "bytes_per_op": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": self.collective_bytes,
                "f32_bytes": self.coll_bytes_f32,
            },
        }


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _decomposes(func) -> bool:
    """True where ``func.decompose`` has a decomposition to run (asked
    first: entering the mode again for every op keeps its operands alive
    past their last use)."""
    key = torch._C.DispatchKey.CompositeImplicitAutograd
    return func is not torch.ops.prim.device.default and (
        key in func.py_kernels
        or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), key))


def _is_view(func) -> bool:
    return func.is_view or func in _VIEWS


def _operand_bytes(t: torch.Tensor) -> int:
    """The bytes ``t``'s strides reach (a stride-0 dimension once)."""
    return t.element_size() * math.prod(
        s for s, st in zip(t.shape, t.stride()) if st != 0)


def _result_bytes(t: torch.Tensor) -> int:
    return t.element_size() * t.numel()


class CostMode(TorchDispatchMode):
    """Counts the flops, bytes and live storage of the ops dispatched
    under it (see the module docstring); ``ops`` is the per-op table
    ``{aten op: [calls, flops, bytes]}``."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = Cost()
        self.ops: Dict[str, List[float]] = {}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, weakref.finalize] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if _decomposes(func):
            # FlopCounterMode's order: decompose what has a decomposition.
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula else 0.0
        nbytes = self._io_bytes(func, args, kwargs, out)
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.n_ops += 1
        row = self.ops.setdefault(str(func), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if not _is_view(func) and not func._schema.is_mutable:
            for t in _tensors(out):
                self._track(t)
        return out

    @staticmethod
    def _io_bytes(func, args, kwargs, out) -> float:
        if _is_view(func):
            return 0.0
        update = _UPDATES.get(func._overloadpacket)
        if update is not None:
            return 2.0 * _operand_bytes(args[update])
        return float(sum(_operand_bytes(t) for t in _tensors((args, kwargs)))
                     + sum(_result_bytes(t) for t in _tensors(out)))

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return
        nbytes = storage.nbytes()
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._storages[key] = weakref.finalize(storage, self._release, key,
                                               nbytes)

    def _release(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live_bytes -= nbytes

    def __exit__(self, *exc):
        # Storages that outlive the step stop being watched.
        for fin in self._storages.values():
            fin.detach()
        self._storages.clear()
        return super().__exit__(*exc)


def count(fn: Callable[..., Any], *args: Any, **kwargs: Any
          ) -> Tuple[Any, CostMode]:
    """``fn(*args, **kwargs)`` under a :class:`CostMode`: (its result, the
    mode with the counts)."""
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode


def analyze(fn: Callable[..., Any], *args: Any, **kwargs: Any
            ) -> Dict[str, object]:
    """Flops, bytes and collectives of ``fn(*args, **kwargs)`` in the
    reference's dict (``collectives`` all zero: see the docstring)."""
    return count(fn, *args, **kwargs)[1].cost.as_dict()
