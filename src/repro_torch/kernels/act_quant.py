"""Per-row activation quantization: wrappers of ``csrc/act_quant.cu``.

Replace ``repro.kernels.act_quant.act_quant`` / ``act_quant_rows`` (Pallas).
A CPU tensor takes the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: x must be f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def act_quant(x: torch.Tensor, *, bits: int = 8,
              signed: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization at one width.  x f32 [M, K] ->
    (int8 [M, K] (uint8 if unsigned), scale f32 [M, 1])."""
    _check_x(x, "act_quant")
    if not 2 <= bits <= 8:
        raise ValueError(f"act_quant: bits must be in 2..8, got {bits}")
    if x.device.type == "cpu":
        return ref.act_quant_ref(x, bits=bits, signed=signed)
    _build.check_cuda(x, "act_quant")
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8 if signed else torch.uint8,
                    device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _build.launch("act_quant_f32", x.device, x, q, s, m, k, bits,
                      int(signed))
        _build.LAUNCHES["act_quant"] += 1
    return q, s


def act_quant_rows(x: torch.Tensor, qmax: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization with a per-row signed range:
    ``qmax`` f32 [M, 1] holds each row's ``2^(b-1) - 1``.  x f32 [M, K] ->
    (int8 [M, K], scale f32 [M, 1])."""
    _check_x(x, "act_quant_rows")
    m, k = x.shape
    if qmax.dtype != torch.float32 or tuple(qmax.shape) != (m, 1) \
            or not qmax.is_contiguous() or qmax.device != x.device:
        raise ValueError(f"act_quant_rows: qmax must be contiguous f32 "
                         f"[{m}, 1] on {x.device}, got {qmax.dtype} "
                         f"{tuple(qmax.shape)} on {qmax.device}")
    if x.device.type == "cpu":
        return ref.act_quant_rows_ref(x, qmax)
    _build.check_cuda(x, "act_quant_rows")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _build.launch("act_quant_rows_f32", x.device, x, qmax, q, s, m, k)
        _build.LAUNCHES["act_quant_rows"] += 1
    return q, s
