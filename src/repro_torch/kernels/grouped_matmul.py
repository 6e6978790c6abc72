"""Group-switching plane-prefix GEMM with the dequant epilogue: wrapper of
``csrc/grouped_matmul.cu``.

Replaces ``repro.kernels.grouped_matmul.grouped_dequant_matmul`` (Pallas).
A CPU tensor takes the plain version (:func:`repro_torch.kernels.ref.
grouped_dequant_matmul_ref`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bitserial_matmul import _vec_ok


def grouped_dequant_matmul(x: torch.Tensor, planes: torch.Tensor,
                           mult: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, row_group: torch.Tensor,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """out [M, N] = ((f32(sum_c (x @ planes[c]) * mult[:, c]) * x_scale)
    * w_scale[row_group]) cast to ``out_dtype``.

    x int8 [M, K] group-sorted rows; planes int8 [Pmax, K, N] MSB-first
    plane prefix; mult int32 [M, Pmax] (``decompose.prefix_multipliers``);
    x_scale f32 [M, 1]; w_scale f32 [G, N], one effective scale row per
    tier group; row_group int32 [M], each row's group."""
    m, k = x.shape
    p, k2, n = planes.shape
    if k2 != k or tuple(mult.shape) != (m, p) or not 1 <= p <= 4:
        raise ValueError(f"grouped_dequant_matmul: shapes x {tuple(x.shape)}"
                         f" planes {tuple(planes.shape)} mult "
                         f"{tuple(mult.shape)}")
    if tuple(x_scale.shape) != (m, 1) or tuple(row_group.shape) != (m,) \
            or w_scale.ndim != 2 or w_scale.shape[1] != n:
        raise ValueError(f"grouped_dequant_matmul: scales x_scale "
                         f"{tuple(x_scale.shape)} w_scale "
                         f"{tuple(w_scale.shape)} row_group "
                         f"{tuple(row_group.shape)}")
    if x.device.type == "cpu":
        return ref.grouped_dequant_matmul_ref(x, planes, mult, x_scale,
                                              w_scale, row_group, out_dtype)
    _build.check_cuda(x, "grouped_dequant_matmul")
    want = ((x, torch.int8), (planes, torch.int8), (mult, torch.int32),
            (x_scale, torch.float32), (w_scale, torch.float32),
            (row_group, torch.int32))
    for t, dt in want:
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"grouped_dequant_matmul: expected contiguous "
                             f"{dt} on {x.device}, got {t.dtype} on "
                             f"{t.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"grouped_dequant_matmul: the kernel writes bf16, "
                         f"asked for {out_dtype}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m and n:
        _build.launch("grouped_dequant_matmul_s8", x.device, x, planes, mult,
                      x_scale, w_scale, row_group, out, m, k, n, p,
                      _vec_ok(x, k), _vec_ok(planes, n))
        _build.LAUNCHES["grouped_dequant_matmul"] += 1
    return out
