"""Plane-decomposed integer GEMMs: wrappers of ``csrc/bitserial_matmul.cu``.

Replace ``repro.kernels.bitserial_matmul.bitserial_matmul`` and
``packed_bitserial_matmul`` (Pallas).  A CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, ref

PACKED_BITS = (2, 4, 6, 8)      # widths the byte-packed store holds


def _vec_ok(t: torch.Tensor, inner: int) -> int:
    """1 when 4-byte words along the contiguous axis are aligned loads."""
    return int(inner % 4 == 0 and t.data_ptr() % 4 == 0)


def bitserial_matmul(x: torch.Tensor, planes: torch.Tensor,
                     shifts: Sequence[int]) -> torch.Tensor:
    """int32 [M, N] = sum_c (x int8 [M, K] @ planes[c] int8 [K, N]) << s_c.

    ``shifts`` has one entry per plane: ``2c`` for LSB-first fixed planes,
    ``decompose.prefix_shifts(P')`` for an MSB-first superplane prefix."""
    if x.ndim != 2 or planes.ndim != 3 or planes.shape[1] != x.shape[1]:
        raise ValueError(f"bitserial_matmul: shapes x {tuple(x.shape)} "
                         f"planes {tuple(planes.shape)}")
    p = planes.shape[0]
    if not 1 <= p <= 4 or len(shifts) != p:
        raise ValueError(f"bitserial_matmul: {p} planes with shifts {shifts}")
    if x.device.type == "cpu":
        return ref.bitserial_matmul_ref(x, planes, shifts)
    _build.check_cuda(x, "bitserial_matmul")
    _build.check_operands("bitserial_matmul", (x, torch.int8),
                          (planes, torch.int8))
    m, k = x.shape
    n = planes.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m and n:
        s = list(shifts) + [0] * (4 - p)
        _build.launch("bitserial_matmul_s8", x.device, x, planes, out, m, k,
                      n, p, *s, _vec_ok(x, k), _vec_ok(planes, n))
        _build.LAUNCHES["bitserial_matmul"] += 1
    return out


def packed_bitserial_matmul(x: torch.Tensor, w_packed: torch.Tensor, *,
                            w_bits: int, eff_bits: Optional[int] = None,
                            signed: bool = True) -> torch.Tensor:
    """int32 [M, N] = sum_c (x int8 [M, K] @ field_c) << 2c over a uint8
    [K, N] store of a ``w_bits`` weight (plane c at bits 2c, 2c+1).

    ``eff_bits`` (default ``w_bits``) runtime-truncates: only the top
    ``eff_bits/2`` fields are read, field ``(w_bits - eff_bits)/2 + c`` for
    plane c, the top one signed iff ``signed``."""
    eff = w_bits if eff_bits is None else eff_bits
    if w_bits not in PACKED_BITS or eff not in PACKED_BITS or eff > w_bits:
        raise ValueError(f"packed_bitserial_matmul: w_bits {w_bits}, "
                         f"eff_bits {eff} (even, eff <= w_bits)")
    if x.ndim != 2 or w_packed.ndim != 2 or w_packed.shape[0] != x.shape[1]:
        raise ValueError(f"packed_bitserial_matmul: shapes x "
                         f"{tuple(x.shape)} packed {tuple(w_packed.shape)}")
    if w_packed.dtype != torch.uint8:
        raise ValueError(f"packed_bitserial_matmul: the store is uint8, got "
                         f"{w_packed.dtype}")
    if x.device.type == "cpu":
        return ref.packed_bitserial_matmul_ref(x, w_packed, w_bits, eff,
                                               signed)
    _build.check_cuda(x, "packed_bitserial_matmul")
    _build.check_operands("packed_bitserial_matmul", (x, torch.int8),
                          (w_packed, torch.uint8))
    m, k = x.shape
    n = w_packed.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m and n:
        _build.launch("packed_bitserial_matmul_u8", x.device, x, w_packed, out,
                      m, k, n, eff // 2, (w_bits - eff) // 2, int(signed),
                      _vec_ok(x, k), _vec_ok(w_packed, n))
        _build.LAUNCHES["packed_bitserial_matmul"] += 1
    return out
