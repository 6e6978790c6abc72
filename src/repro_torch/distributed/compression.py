"""Quantized gradient all-reduce with error feedback — the paper's operand
decomposition reused as a wire format for data-parallel training (port of
``repro.distributed.compression``).

Each rank quantizes its local gradient against a globally agreed scale
(one scalar all-reduce of the max), sums the *integer* codes across the
mesh axis, and dequantizes.  Quantization error is carried in a per-rank
error-feedback buffer, which preserves convergence (Karimireddy et
al.-style EF-SGD argument).  The optional 2-bit mode keeps one Table-I
MSB plane of ``core.decompose`` (values in [-2, 1]).

Wire bytes per gradient element: 4 at both widths, since the codes are
summed as int32, as the reference's psum sums them (the reference's
docstring gives 1 B (int8) and 2 bits; no code of either package sends
that).  :data:`WIRE_BYTES` counts what this rank hands to the all-reduces.

Numerics are the reference's: ``ref.quant_scale`` (reciprocal multiply),
IEEE division, round half to even, clip to ``[-qmax - 1, qmax]``; the
integer sum is exact in any order, and ``/ n`` is exact at a power of two,
so the mean equals the reference's bit for bit there.  The residual is
``corrected - q * scale`` as two roundings; the jitted reference may
contract it into one FMA.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import decompose
from repro_torch.distributed import comm
from repro_torch.kernels import ref
from repro_torch.train.optimizer import tree_map

# Bytes this rank hands to the all-reduces: the integer ``codes`` and the
# f32 ``amax`` scalars.
WIRE_BYTES: Dict[str, int] = {"codes": 0, "amax": 0}


def reset_wire_bytes() -> None:
    for key in WIRE_BYTES:
        WIRE_BYTES[key] = 0


def compressed_psum(g: torch.Tensor, err: torch.Tensor, *, mesh: Any,
                    axis_name: str, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean of one f32 tensor over the mesh's ``axis_name``,
    with error feedback.  g, err: this rank's tensors (same shape).
    Returns (mean_grad, new_err); every rank of the line calls it."""
    if bits not in (2, 8):
        raise ValueError(f"compressed_psum: bits must be 2 or 8, not {bits}")
    group = mesh.group(axis_name)
    n_dev = mesh.axis_size(axis_name)
    # In-place steps keep one full-size temporary at a time (a leaf may be
    # the 0.6 G-entry embedding); each computes what its out-of-place
    # form does, bit for bit.
    corrected = g + err
    amax_local = torch.maximum(corrected.amax(), -corrected.amin())
    amax = comm.all_reduce(amax_local, group,
                           op=dist.ReduceOp.MAX)   # scalar collective
    WIRE_BYTES["amax"] += 4
    qmax = 127 if bits == 8 else 1
    scale = ref.quant_scale(amax, qmax, eps=1e-12)
    q = (corrected / scale).round_().clamp_(-qmax - 1, qmax)
    new_err = corrected.sub_(q * scale)                # error feedback
    codes = q.to(torch.int32)
    del q
    if bits == 2:
        # 2-bit plane mode: values in [-2, 1] = one Table-I MSB plane.
        codes = decompose.decompose_weights(codes, 2, signed=True)[0].to(
            torch.int32)
    total = comm.all_reduce(codes, group)
    WIRE_BYTES["codes"] += codes.numel() * codes.element_size()
    del codes
    mean = total.to(torch.float32).mul_(scale).div_(n_dev)
    return mean, new_err


def compressed_psum_tree(grads: Any, err_tree: Any, *, mesh: Any,
                         axis_name: str, bits: int = 8) -> Tuple[Any, Any]:
    """Tree version, leaf by leaf (each leaf its own scale); returns
    (mean_grads, new_err_tree)."""
    new_errs = []

    def one(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
        mean, new_err = compressed_psum(g.to(torch.float32), err, mesh=mesh,
                                        axis_name=axis_name, bits=bits)
        new_errs.append(new_err)
        return mean
    means = tree_map(one, grads, err_tree)
    order = iter(new_errs)       # tree_map visits the leaves in one order
    return means, tree_map(lambda _: next(order), grads)


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
