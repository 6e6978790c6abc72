"""Per-row activation quantization: wrappers of ``csrc/act_quant.cu``.

Replace ``repro.kernels.act_quant.act_quant`` / ``act_quant_rows`` (Pallas).
Both read ``x`` in its own dtype (bf16 or f32) and take an optional row
index ``perm``: output row ``i`` quantizes ``x[perm[i]]``, so a caller
hands over a view of its activation and makes no gathered or f32 copy.
A CPU tensor takes the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

_X_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(x: torch.Tensor, perm: Optional[torch.Tensor],
                name: str) -> int:
    """Checks ``x`` [R, K] and ``perm``; returns the output's row count.
    ``perm``'s values are the caller's contract (reading them would wait
    for the card)."""
    if x.dtype not in _X_DTYPES or x.ndim != 2:
        raise ValueError(f"{name}: x must be f32 or bf16 [R, K], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError(f"{name}: x's last axis must be contiguous")
    if perm is None:
        return x.shape[0]
    if perm.ndim != 1 or perm.dtype not in (torch.int32, torch.int64) \
            or perm.device != x.device:
        raise ValueError(f"{name}: perm must be a 1-D int32/int64 tensor on "
                         f"{x.device}, got {perm.dtype} "
                         f"{tuple(perm.shape)} on {perm.device}")
    return perm.shape[0]


def _source(x: torch.Tensor, perm: Optional[torch.Tensor]) -> tuple:
    """The C entries' leading arguments: x, its dtype flag, its row
    stride in elements, perm (or None) and perm's width flag."""
    ldx = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    return (x, int(x.dtype == torch.bfloat16), ldx, perm,
            int(perm is not None and perm.dtype == torch.int64))


def act_quant(x: torch.Tensor, *, bits: int = 8, signed: bool = True,
              perm: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization at one width.  x f32/bf16 [R, K]
    (rows ``perm`` [M], else all R) -> (int8 [M, K] (uint8 if unsigned),
    scale f32 [M, 1])."""
    m = _check_rows(x, perm, "act_quant")
    if not 2 <= bits <= 8:
        raise ValueError(f"act_quant: bits must be in 2..8, got {bits}")
    if x.device.type == "cpu":
        return ref.act_quant_ref(x, bits=bits, signed=signed, perm=perm)
    _build.check_cuda(x, "act_quant")
    k = x.shape[1]
    q = torch.empty((m, k), dtype=torch.int8 if signed else torch.uint8,
                    device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _build.launch("act_quant_gather", x.device, *_source(x, perm), q, s,
                      m, k, bits, int(signed))
        _build.LAUNCHES["act_quant"] += 1
    return q, s


def act_quant_rows(x: torch.Tensor, qmax: torch.Tensor,
                   perm: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization with a per-row signed range:
    ``qmax`` f32 [M, 1] holds each output row's ``2^(b-1) - 1``.
    x f32/bf16 [R, K] (rows ``perm`` [M], else all R) -> (int8 [M, K],
    scale f32 [M, 1])."""
    m = _check_rows(x, perm, "act_quant_rows")
    if qmax.dtype != torch.float32 or tuple(qmax.shape) != (m, 1) \
            or not qmax.is_contiguous() or qmax.device != x.device:
        raise ValueError(f"act_quant_rows: qmax must be contiguous f32 "
                         f"[{m}, 1] on {x.device}, got {qmax.dtype} "
                         f"{tuple(qmax.shape)} on {qmax.device}")
    if x.device.type == "cpu":
        return ref.act_quant_rows_ref(x, qmax, perm=perm)
    _build.check_cuda(x, "act_quant_rows")
    k = x.shape[1]
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _build.launch("act_quant_rows_gather", x.device, *_source(x, perm),
                      qmax, q, s, m, k)
        _build.LAUNCHES["act_quant_rows"] += 1
    return q, s


def noop(device: torch.device) -> None:
    """Launches the empty kernel: the least a launch costs on the card,
    timed beside kernels 1 and 2 (``chip_smoke.py``).  Not counted: no
    serving path runs it."""
    _build.launch("repro_noop", device)
