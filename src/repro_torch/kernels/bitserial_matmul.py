"""Plane-decomposed integer GEMM: wrapper of ``csrc/bitserial_matmul.cu``.

Replaces ``repro.kernels.bitserial_matmul.bitserial_matmul`` (Pallas).  A CPU
tensor takes the plain version (:func:`repro_torch.kernels.ref.
bitserial_matmul_ref`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, ref


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
    if x.dtype != torch.int8 or planes.dtype != torch.int8:
        raise ValueError(f"bitserial_matmul: the kernel takes int8 x and "
                         f"planes, got {x.dtype} and {planes.dtype}")
    if not (x.is_contiguous() and planes.is_contiguous()):
        raise ValueError("bitserial_matmul: x and planes must be contiguous")
    if planes.device != x.device:
        raise ValueError("bitserial_matmul: x and planes on different devices")
    m, k = x.shape
    n = planes.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m and n:
        s = list(shifts) + [0] * (4 - p)
        _build.launch("bitserial_matmul_s8", x.device, x, planes, out, m, k,
                      n, p, *s, _vec_ok(x, k), _vec_ok(planes, n))
        _build.LAUNCHES["bitserial_matmul"] += 1
    return out
