"""Table-I weight decomposition (port of ``repro.core.decompose``).

An M-bit weight (M in 2..8) is decomposed into a fixed MSB->LSB schedule of
2-bit and 3-bit chunks (paper Table I).  Only the MSB chunk can be 3 bits
wide and only the MSB chunk carries the sign, so plane ``c`` (LSB-first)
always sits at shift ``2*c``.

The integer products here are the plain versions the kernels are held
against.  ``torch.matmul`` has no int32 CUDA path, so they run in float64:
every partial sum is an integer far below 2**53, hence exact in any
summation order, on the CPU and on the card alike.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# MSB -> LSB chunk widths, straight from paper Table I.
DECOMP_SCHEDULE: dict[int, tuple[int, ...]] = {
    2: (2,),
    3: (3,),
    4: (2, 2),
    5: (3, 2),
    6: (2, 2, 2),
    7: (3, 2, 2),
    8: (2, 2, 2, 2),
}

SUPPORTED_BITS = tuple(sorted(DECOMP_SCHEDULE))


def schedule(w_bits: int, signed: bool = True) -> tuple[int, ...]:
    """Effective MSB->LSB chunk schedule; odd unsigned widths promote to the
    next even schedule (unsigned chunks are always 2-bit)."""
    if not signed and w_bits % 2 == 1:
        return DECOMP_SCHEDULE[w_bits + 1]
    return DECOMP_SCHEDULE[w_bits]


def num_planes(w_bits: int, signed: bool = True) -> int:
    """Number of decomposed planes (physical columns per logical weight)."""
    return len(schedule(w_bits, signed))


def plane_shifts(w_bits: int, signed: bool = True) -> tuple[int, ...]:
    """Arithmetic left-shift of each plane, LSB-first.  Always (0, 2, 4, 6)[:P]."""
    return tuple(2 * c for c in range(num_planes(w_bits, signed)))


def plane_widths_lsb_first(w_bits: int, signed: bool = True) -> tuple[int, ...]:
    return tuple(reversed(schedule(w_bits, signed)))


def msb_plane_width(w_bits: int, signed: bool = True) -> int:
    """Width of the sign-carrying MSB chunk (2: '2-bit mode', 3: '3-bit
    mode')."""
    return schedule(w_bits, signed)[0]


def weight_range(w_bits: int, signed: bool) -> tuple[int, int]:
    """Representable integer range for an M-bit (un)signed weight."""
    if signed:
        return -(1 << (w_bits - 1)), (1 << (w_bits - 1)) - 1
    return 0, (1 << w_bits) - 1


def plane_value_range(w_bits: int, plane: int,
                      signed: bool) -> tuple[int, int]:
    """Value range of decomposed plane ``plane`` (LSB-first index)."""
    widths = plane_widths_lsb_first(w_bits, signed)
    w = widths[plane]
    if plane == len(widths) - 1 and signed:
        return -(1 << (w - 1)), (1 << (w - 1)) - 1
    return 0, (1 << w) - 1


def _plane_list(w: torch.Tensor, w_bits: int,
                signed: bool) -> List[torch.Tensor]:
    """The int8 planes of :func:`decompose_weights`, LSB first, each made
    int8 as soon as it exists (a weight of 10^9 entries then needs one
    int32 copy at a time, not one per plane)."""
    if w_bits not in DECOMP_SCHEDULE:
        raise ValueError(f"w_bits must be in {SUPPORTED_BITS}, got {w_bits}")
    widths = plane_widths_lsb_first(w_bits, signed)
    # Two's-complement bit pattern of the weight, as an unsigned field.
    u = w.to(torch.int32) & ((1 << w_bits) - 1)
    planes = []
    shift = 0
    for i, width in enumerate(widths):
        chunk = (u >> shift) & ((1 << width) - 1)
        if i == len(widths) - 1 and signed:
            # Reinterpret the MSB chunk as a `width`-bit signed value.
            chunk = torch.where(chunk >= (1 << (width - 1)),
                                chunk - (1 << width), chunk)
        planes.append(chunk.to(torch.int8))
        shift += width
    return planes


def decompose_weights(w: torch.Tensor, w_bits: int, *,
                      signed: bool = True) -> torch.Tensor:
    """Integer weights -> int8 planes ``[P, *w.shape]``, LSB-first (plane
    ``c`` weighs ``4**c``).  The MSB plane is signed iff ``signed``; the
    other planes are unsigned 2-bit values in [0, 3]."""
    return torch.stack(_plane_list(w, w_bits, signed))


def recompose_weights(planes: torch.Tensor, w_bits: int, *,
                      signed: bool = True) -> torch.Tensor:
    """Exact inverse of :func:`decompose_weights` (int32 output)."""
    shifts = plane_shifts(w_bits, signed)
    if planes_count(planes) != len(shifts):
        raise ValueError(
            f"plane count {planes_count(planes)} != schedule {len(shifts)} "
            f"for {w_bits}-bit")
    acc = torch.zeros(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    for c, s in enumerate(shifts):
        acc = acc + (planes[c].to(torch.int32) << s)
    return acc


def planes_count(w_planes: torch.Tensor) -> int:
    """Planes in a stack of planes (its leading axis)."""
    return w_planes.shape[0]


# ------------------------------------------------------------- superplanes
# Every weight decomposed ONCE at 8 bits, planes kept MSB-first so that the
# first P' planes are the Table-I decomposition of the LSB-truncated weight:
#     recompose(planes[:P']) == q8 >> (2 * (4 - P'))   (arithmetic shift)

SUPERPLANE_BITS = 8
SUPERPLANE_PLANES = 4
RUNTIME_W_BITS = (2, 4, 6, 8)   # widths reachable by plane-prefix truncation


def decompose_superplanes(q8: torch.Tensor, *,
                          signed: bool = True) -> torch.Tensor:
    """8-bit integer weight -> four MSB-FIRST 2-bit planes, int8
    ``[4, *q8.shape]``; ``planes[0]`` carries the sign iff ``signed``."""
    return torch.stack(_plane_list(q8, SUPERPLANE_BITS, signed)[::-1])


def num_prefix_planes(eff_bits: int) -> int:
    """Plane-prefix length serving an effective weight width."""
    if eff_bits not in RUNTIME_W_BITS:
        raise ValueError(
            f"runtime-truncatable widths are {RUNTIME_W_BITS}, got {eff_bits}")
    return eff_bits // 2


def prefix_shifts(num_planes: int) -> tuple[int, ...]:
    """Arithmetic left-shift per MSB-first plane: plane i weighs 4^(P'-1-i)."""
    return tuple(2 * (num_planes - 1 - c) for c in range(num_planes))


def superplane_prefix(planes_msb: torch.Tensor,
                      eff_bits: int) -> torch.Tensor:
    """The MSB plane prefix serving ``eff_bits`` (still MSB-first; a view)."""
    return planes_msb[: num_prefix_planes(eff_bits)]


def recompose_superplane_prefix(planes_msb: torch.Tensor, eff_bits: int, *,
                                signed: bool = True) -> torch.Tensor:
    """Integer value of a truncated superplane == ``q8 >> (8 - eff_bits)``."""
    prefix = superplane_prefix(planes_msb, eff_bits)
    return recompose_weights(prefix.flip(0), eff_bits, signed=signed)


def prefix_multipliers(plane_groups: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Per-row plane-multiplier table for group-switching GEMMs: row ``r``
    of a group serving ``P'`` MSB-first planes weighs plane ``c`` by
    ``4**(P'-1-c)`` and planes beyond its prefix by 0.

    ``plane_groups``: ``(rows, num_planes)`` per contiguous group.
    Returns np.int32 ``[sum(rows), max(num_planes)]``."""
    pmax = max(p for _, p in plane_groups)
    total = sum(r for r, _ in plane_groups)
    mult = np.zeros((total, pmax), np.int32)
    off = 0
    for rows, p in plane_groups:
        for c in range(p):
            mult[off:off + rows, c] = 4 ** (p - 1 - c)
        off += rows
    return mult


def int_matmul(x_int: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``x @ plane`` for small integers (float64, see module
    doc)."""
    return torch.matmul(x_int.to(torch.float64),
                        plane.to(torch.float64)).to(torch.int32)


def decomposed_matmul_multipliers(x_int: torch.Tensor,
                                  planes_msb: torch.Tensor,
                                  mult: torch.Tensor) -> torch.Tensor:
    """``sum_c (x_int @ planes_msb[c]) * mult[:, c]`` in int32 — the plain
    version of the group-switching GEMM.  x_int [M, K], planes_msb int8
    [Pmax, K, N], mult int32 [M, Pmax] -> int32 [M, N]."""
    acc = None
    for c in range(planes_msb.shape[0]):
        part = int_matmul(x_int, planes_msb[c]) * mult[:, c:c + 1]
        acc = part if acc is None else acc + part
    assert acc is not None
    return acc


def decomposed_matmul_shifts(x_int: torch.Tensor, w_planes: torch.Tensor,
                             shifts: Sequence[int]) -> torch.Tensor:
    """``sum_c (x_int @ w_planes[c]) << shifts[c]`` in int32."""
    acc = None
    for c, s in enumerate(shifts):
        part = int_matmul(x_int, w_planes[c]) << s
        acc = part if acc is None else acc + part
    assert acc is not None
    return acc


def decomposed_matmul(x_int: torch.Tensor, w_planes: torch.Tensor,
                      w_bits: int) -> torch.Tensor:
    """``x_int @ recompose(w_planes)`` the paper's way: one integer matmul
    per LSB-first plane, partial sums combined with shifts ``2c``.
    x_int [..., K], w_planes int8 [P, K, N] -> int32 [..., N]."""
    del w_bits   # the shift schedule is 2c per plane for every schedule
    return decomposed_matmul_shifts(
        x_int, w_planes, tuple(2 * c for c in range(planes_count(w_planes))))


def decomposed_matmul_grouped(x_int: torch.Tensor, planes_msb: torch.Tensor,
                              row_groups: Sequence[Tuple[int, int]]
                              ) -> torch.Tensor:
    """Per-row-group effective-width oracle (mixed-tier decode batches):
    each contiguous group ``(rows, eff_bits)`` of x's leading axis runs
    :func:`decomposed_matmul` against its own MSB plane prefix of the
    superplane store, and the groups are concatenated back.
    x_int [B, ..., K], planes_msb int8 [4, K, N] -> int32 [B, ..., N]."""
    total = sum(r for r, _ in row_groups)
    if total != x_int.shape[0]:
        raise ValueError(f"row_groups cover {total} rows, x has "
                         f"{x_int.shape[0]}")
    outs, off = [], 0
    for rows, eff_bits in row_groups:
        prefix = superplane_prefix(planes_msb, eff_bits).flip(0)  # LSB-first
        outs.append(decomposed_matmul(x_int[off:off + rows], prefix,
                                      eff_bits))
        off += rows
    return torch.cat(outs, dim=0)
