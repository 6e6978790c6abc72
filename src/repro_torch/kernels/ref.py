"""Plain PyTorch versions of the six kernels (port of ``repro.kernels.ref``
plus the epilogue of ``ops.fused_decode_linear``).

Each is the semantic ground truth its CUDA kernel is held against, bit for
bit: the CPU tests run them (the wrappers take them only for CPU tensors)
and ``chip_smoke.py`` compares each kernel with them on the card.  The
packed versions take the uint8 store itself and extract its 2-bit fields
here (:func:`packed_field`), independently of ``ops.unpack_planes``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import decompose


def quant_scale(amax: torch.Tensor, qmax: Union[torch.Tensor, float],
                eps: float = 1e-8) -> torch.Tensor:
    """THE activation scale rule: ``max(amax, eps) * (1/qmax)`` in f32.

    A reciprocal-multiply on purpose (the weight scale divides): the
    reference pins every activation scale to this form.  ``1/qmax`` is an
    IEEE f32 division — computed in numpy for a constant, as a tensor
    division for a per-row range (``1.0 / t`` in torch would go through
    ``reciprocal``)."""
    if isinstance(qmax, torch.Tensor):
        inv = torch.div(torch.ones_like(qmax), qmax)
    else:
        inv = float(np.float32(1.0) / np.float32(qmax))
    return torch.clamp_min(amax, eps) * inv


def _gathered_f32(x: torch.Tensor,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``f32(x)[perm]`` (all rows without ``perm``): the rows the act-quant
    kernels read, widened to f32 (exact from bf16)."""
    if perm is not None:
        x = x.index_select(0, perm)
    return x.to(torch.float32)


def act_quant_ref(x: torch.Tensor, bits: int = 8, signed: bool = True,
                  perm: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric activation quantization at one width.
    x f32/bf16 [R, K] (rows ``perm`` [M], else all R) -> (int8 [M, K]
    (uint8 if unsigned), scale f32 [M, 1])."""
    x = _gathered_f32(x, perm)
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    qmin = -(1 << (bits - 1)) if signed else 0
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = quant_scale(amax, qmax)
    dtype = torch.int8 if signed else torch.uint8
    q = torch.clamp(torch.round(x / scale), qmin, qmax).to(dtype)
    return q, scale.to(torch.float32)


def act_quant_rows_ref(x: torch.Tensor, qmax: torch.Tensor,
                       perm: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row-range quantization (signed) of ``f32(x)[perm]``: ``qmax``
    f32 [M, 1] carries each output row's ``2^(b-1) - 1``.  Returns
    (int8 [M, K], scale f32 [M, 1])."""
    x = _gathered_f32(x, perm)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = quant_scale(amax, qmax)
    q = torch.clamp(torch.round(x / scale), min=-qmax - 1.0, max=qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def bitserial_matmul_ref(x_int: torch.Tensor, planes: torch.Tensor,
                         shifts: Sequence[int]) -> torch.Tensor:
    """int32 [M, N] = sum_c (x @ planes[c]) << shifts[c]."""
    return decompose.decomposed_matmul_shifts(x_int, planes, shifts)


def quantized_matmul_ref(x: torch.Tensor, w_planes: torch.Tensor,
                         w_scale: torch.Tensor, w_bits: int,
                         a_bits: int = 8) -> torch.Tensor:
    """Float in, float out: per-row activation quantization, the integer
    decomposed matmul over LSB-first planes, both scales out.
    x [M, K], w_planes int8 [P, K, N], w_scale f32 [1, N] -> f32 [M, N]."""
    q, s = act_quant_ref(x, bits=a_bits)
    acc = decompose.decomposed_matmul(q, w_planes, w_bits)
    return acc.to(torch.float32) * s * w_scale


def packed_field(w_packed: torch.Tensor, field: int,
                 sign: bool) -> torch.Tensor:
    """Byte field ``field`` (bits ``2*field .. 2*field+1``) of a uint8 store
    as int8, read as signed [-2, 1] when ``sign``, else as [0, 3]."""
    f = (w_packed >> (2 * field)) & 0x3          # uint8: logical shift
    return torch.where(f >= 2, f.to(torch.int8) - 4, f.to(torch.int8)) \
        if sign else f.to(torch.int8)


def packed_bitserial_matmul_ref(x_int: torch.Tensor, w_packed: torch.Tensor,
                                w_bits: int, eff_bits: int,
                                signed: bool = True) -> torch.Tensor:
    """int32 [M, N] = sum_c (x @ field_c) << 2c over the top ``eff_bits/2``
    fields of a ``w_bits`` store: ``field_c`` is byte field ``base/2 + c``
    with ``base = w_bits - eff_bits``, the top one signed iff ``signed``."""
    p = eff_bits // 2
    first = (w_bits - eff_bits) // 2
    fields = torch.stack([packed_field(w_packed, first + c,
                                       signed and c == p - 1)
                          for c in range(p)])
    return decompose.decomposed_matmul_shifts(
        x_int, fields, tuple(2 * c for c in range(p)))


def _msb_planes(w: torch.Tensor, pmax: int, packed: bool, store_planes: int,
                signed: bool) -> torch.Tensor:
    """The first ``pmax`` MSB-first planes of either layout: int8 planes as
    given, or byte fields ``store_planes - 1 - c`` of a uint8 store, only
    the store's top field signed."""
    if not packed:
        return w
    return torch.stack([packed_field(w, store_planes - 1 - c,
                                     signed and c == 0)
                        for c in range(pmax)])


def grouped_matmul_ref(x_int: torch.Tensor, w: torch.Tensor,
                       mult: torch.Tensor, *, packed: bool = False,
                       store_planes: int = decompose.SUPERPLANE_PLANES,
                       signed: bool = True) -> torch.Tensor:
    """int32 [M, N] = sum_c (x @ plane_c) * mult[:, c]; ``w`` is int8
    [Pmax, K, N] MSB-first planes, or a uint8 [K, N] store (``packed``)."""
    planes = _msb_planes(w, mult.shape[1], packed, store_planes, signed)
    return decompose.decomposed_matmul_multipliers(x_int, planes, mult)


def grouped_dequant_matmul_ref(x_int: torch.Tensor, w: torch.Tensor,
                               mult: torch.Tensor, x_scale: torch.Tensor,
                               w_scale: torch.Tensor, row_group: torch.Tensor,
                               out_dtype: torch.dtype = torch.bfloat16, *,
                               packed: bool = False,
                               store_planes: int = decompose.SUPERPLANE_PLANES,
                               signed: bool = True) -> torch.Tensor:
    """``((f32(sum_c (x @ plane_c) * mult[:, c]) * x_scale) * w_scale)``
    cast to ``out_dtype``, planes as in :func:`grouped_matmul_ref`.
    ``w_scale`` holds one effective scale row per row group [G, N];
    ``row_group`` int [M] names each row's group."""
    acc = grouped_matmul_ref(x_int, w, mult, packed=packed,
                             store_planes=store_planes, signed=signed)
    ws = w_scale.index_select(0, row_group.to(torch.int64))
    return ((acc.to(torch.float32) * x_scale) * ws).to(out_dtype)
