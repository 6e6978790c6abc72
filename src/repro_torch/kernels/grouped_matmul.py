"""Group-switching plane-prefix GEMMs: wrappers of ``csrc/grouped_matmul.cu``.

Replace ``repro.kernels.grouped_matmul.grouped_matmul`` (raw int32) and
``grouped_dequant_matmul`` (with the dequant epilogue), Pallas.  Both read
the weight as int8 MSB-first planes [Pmax, K, N] or, with ``packed``, as a
uint8 [K, N] store whose MSB-first plane c is byte field
``store_planes - 1 - c``.  A CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or
raises.  The launch plan is the shift GEMMs' (``bitserial_matmul.plan``,
with Pmax planes), since both run on the core ``csrc/plane_mma.cuh``.
"""
from __future__ import annotations

import torch

from repro_torch.core import decompose
from repro_torch.kernels import _build, ref
from repro_torch.kernels.bitserial_matmul import _launch

STORE_PLANES: int = decompose.SUPERPLANE_PLANES   # byte fields per weight


def _check(name: str, x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
           packed: bool, store_planes: int) -> int:
    """Validates the shapes and the layout; returns N."""
    if packed:
        if w.ndim != 2 or w.dtype != torch.uint8:
            raise ValueError(f"{name}: packed=True takes a uint8 [K, N] "
                             f"store, got {w.dtype} {tuple(w.shape)}")
        k2, n = w.shape
        p_ok = 1 <= mult.shape[1] <= store_planes <= 4
    else:
        if w.ndim != 3:
            raise ValueError(f"{name}: packed=False takes planes [Pmax, K, "
                             f"N], got {w.dtype} {tuple(w.shape)}")
        p, k2, n = w.shape
        p_ok = mult.shape[1] == p and 1 <= p <= 4
    if x.ndim != 2 or k2 != x.shape[1] or mult.ndim != 2 \
            or mult.shape[0] != x.shape[0] or not p_ok:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mult {tuple(mult.shape)} "
                         f"store_planes {store_planes}")
    return n


def _gemm_args(packed, store_planes, signed):
    """Weight dtype and the launch's scalars between P and the alignment
    flags."""
    if packed:
        return torch.uint8, (store_planes, int(signed))
    return torch.int8, ()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, *,
                   packed: bool = False,
                   store_planes: int = STORE_PLANES,
                   signed: bool = True) -> torch.Tensor:
    """int32 [M, N] = sum_c (x @ plane_c) * mult[:, c].

    x int8 [M, K] group-sorted rows; ``w`` int8 [Pmax, K, N] MSB-first plane
    prefix, or the uint8 [K, N] store (``packed``; ``store_planes`` fields,
    the top one signed iff ``signed``); mult int32 [M, Pmax]
    (``decompose.prefix_multipliers``)."""
    n = _check("grouped_matmul", x, w, mult, packed, store_planes)
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, mult, packed=packed,
                                      store_planes=store_planes, signed=signed)
    _build.check_cuda(x, "grouped_matmul")
    wdt, args = _gemm_args(packed, store_planes, signed)
    _build.check_operands("grouped_matmul", (x, torch.int8), (w, wdt),
                          (mult, torch.int32))
    return _launch("grouped_matmul_u8" if packed else "grouped_matmul_s8",
                   "grouped_matmul", x, w, n, mult.shape[1], packed, args,
                   operands=(mult,))


def grouped_dequant_matmul(x: torch.Tensor, w: torch.Tensor,
                           mult: torch.Tensor, x_scale: torch.Tensor,
                           w_scale: torch.Tensor, row_group: torch.Tensor,
                           out_dtype: torch.dtype = torch.bfloat16, *,
                           packed: bool = False,
                           store_planes: int = STORE_PLANES,
                           signed: bool = True) -> torch.Tensor:
    """out [M, N] = ((f32(sum_c (x @ plane_c) * mult[:, c]) * x_scale)
    * w_scale[row_group]) cast to ``out_dtype``.

    x, ``w``, mult, ``packed``, ``store_planes`` and ``signed`` as in
    :func:`grouped_matmul`; x_scale f32 [M, 1]; w_scale f32 [G, N], one
    effective scale row per tier group; row_group int32 [M], each row's
    group."""
    n = _check("grouped_dequant_matmul", x, w, mult, packed, store_planes)
    m = x.shape[0]
    if tuple(x_scale.shape) != (m, 1) or tuple(row_group.shape) != (m,) \
            or w_scale.ndim != 2 or w_scale.shape[1] != n:
        raise ValueError(f"grouped_dequant_matmul: scales x_scale "
                         f"{tuple(x_scale.shape)} w_scale "
                         f"{tuple(w_scale.shape)} row_group "
                         f"{tuple(row_group.shape)}")
    if x.device.type == "cpu":
        return ref.grouped_dequant_matmul_ref(
            x, w, mult, x_scale, w_scale, row_group, out_dtype, packed=packed,
            store_planes=store_planes, signed=signed)
    _build.check_cuda(x, "grouped_dequant_matmul")
    wdt, args = _gemm_args(packed, store_planes, signed)
    _build.check_operands("grouped_dequant_matmul", (x, torch.int8),
                          (w, wdt), (mult, torch.int32),
                          (x_scale, torch.float32), (w_scale, torch.float32),
                          (row_group, torch.int32))
    if out_dtype != torch.bfloat16:
        raise ValueError(f"grouped_dequant_matmul: the kernel writes bf16, "
                         f"asked for {out_dtype}")
    return _launch("grouped_dequant_matmul_u8" if packed
                   else "grouped_dequant_matmul_s8", "grouped_dequant_matmul",
                   x, w, n, mult.shape[1], packed, args,
                   operands=(mult, x_scale, w_scale, row_group),
                   out_dtype=torch.bfloat16)
