"""Plane-decomposed integer GEMMs: wrappers of ``csrc/bitserial_matmul.cu``.

Replace ``repro.kernels.bitserial_matmul.bitserial_matmul`` and
``packed_bitserial_matmul`` (Pallas).  A CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or
raises.  :func:`plan` chooses each launch's row tile, K stage depth and K
slices (split-K) for every GEMM on the core ``csrc/plane_mma.cuh``, these
two and the grouped ones (:mod:`repro_torch.kernels.grouped_matmul`); it is
pure Python, so the CPU tests hold it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref

PACKED_BITS = (2, 4, 6, 8)      # widths the byte-packed store holds

# The shared-memory layout of csrc/plane_mma.cuh (kBN, kStages, kXPad,
# kMaxSmem).  The plan's ``smem`` is passed to the kernel, which refuses a
# launch whose request differs from its own layout's, so a change on either
# side fails every launch on the card (tests/test_torch_gpu.py).
BN = 128                        # output columns per block
STAGES = 4                      # slots of the cp.async ring
X_PAD = 16                      # padding bytes per x row in shared memory
MAX_SMEM = 227 * 1024           # dynamic shared memory a block may use
ROW_TILES = (16, 32, 64)        # rows per block (one to four m16 MMA tiles)
STAGE_WEIGHT_BYTES = 16 * 1024  # raw weight bytes per stage, the aim
BLOCKS_PER_SM = 2               # resident blocks the shared memory allows
MIN_SLICE_STAGES = 2            # K stages per slice at the least
H100_SMS = 132


class Plan(NamedTuple):
    """One launch: ``bm`` rows x ``BN`` columns per block, K in stages of
    ``bk``, split into ``splits`` slices of ``kslice`` (a whole number of
    stages; the last may be shorter); ``smem`` dynamic shared bytes.  A
    split launch sums its slices through ``workspace`` int32 (one ``bm`` x
    ``BN`` tile per output tile and slice) under ``counters`` int32 (one
    per output tile); both are 0 without a split."""
    bm: int
    bk: int
    kslice: int
    splits: int
    grid: tuple
    smem: int
    workspace: int
    counters: int


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, p: int, packed: bool = False,
         sms: int = H100_SMS) -> Plan:
    """The launch of an [m, k] x [k, n] plane GEMM over ``p`` int8 planes
    (``packed``: one uint8 store, read once for all ``p`` fields); the
    same for the shift GEMMs and the grouped ones (``p`` = Pmax).

    Rows: the smallest tile of ``ROW_TILES`` that holds ``m``; beyond 64
    rows, tiles of 64 (each weight byte is read once per 64 rows).  Stage
    depth: about ``STAGE_WEIGHT_BYTES`` of raw weight per stage, halved
    (down to 32) while the output tiles times the stages cannot give each
    of the card's resident blocks (``BLOCKS_PER_SM`` on each of ``sms``
    SMs) ``MIN_SLICE_STAGES`` stages.  Split-K: where the output tiles are
    fewer than those resident blocks, as many K slices of equal length (at
    least ``MIN_SLICE_STAGES`` stages) as one wave of them holds."""
    if min(m, k, n) < 0 or not 1 <= p <= 4:
        raise ValueError(f"plan: m {m} k {k} n {n} p {p}")
    bm = next((b for b in ROW_TILES if m <= b), ROW_TILES[-1])
    grid_n, grid_m = math.ceil(n / BN), math.ceil(m / bm)
    tiles = grid_n * grid_m
    slots = BLOCKS_PER_SM * sms     # one wave of resident blocks
    w_tiles = 1 if packed else p
    bk = max(32, min(128, STAGE_WEIGHT_BYTES // (w_tiles * BN) // 32 * 32))
    while bk > 32 and tiles * math.ceil(k / bk) < slots * MIN_SLICE_STAGES:
        bk //= 2
    stages = math.ceil(k / bk)
    per_slice = max(stages, 1)
    if 0 < tiles < slots:   # as many slices as one wave of blocks holds
        per_slice = max(MIN_SLICE_STAGES, math.ceil(stages / (slots // tiles)))
    splits = max(1, math.ceil(stages / per_slice))
    smem = STAGES * (w_tiles * bk * BN + bm * (bk + X_PAD))
    split = splits > 1
    return Plan(bm, bk, per_slice * bk, splits, (grid_n, grid_m, splits),
                smem, splits * tiles * bm * BN if split else 0,
                tiles if split else 0)


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec_ok(t: torch.Tensor, inner: int, align: int = 16) -> int:
    """1 when ``align``-byte chunks along the contiguous axis are aligned
    (the core copies 16-byte chunks with cp.async; otherwise it takes its
    masked byte loads)."""
    return int(inner % align == 0 and t.data_ptr() % align == 0)


# Split-K scratch per (device, stream): (counters, workspace), int32, grown
# when a plan needs more.  The counters are zero between launches: the last
# slice of each output tile resets its own.
_SCRATCH: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_scratch(device: torch.device, pl: Plan) -> tuple:
    """(counters, workspace) for a launch of ``pl`` on the current stream,
    or (None, None) without a split."""
    if pl.splits == 1:
        return None, None
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    cnt, ws = _SCRATCH.get(key, (None, None))
    if cnt is None or cnt.numel() < pl.counters:
        cnt = torch.zeros(pl.counters, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < pl.workspace:
        ws = torch.empty(pl.workspace, dtype=torch.int32, device=device)
    _SCRATCH[key] = (cnt, ws)
    return cnt, ws


def _launch(name: str, counter: str, x: torch.Tensor, w: torch.Tensor, n: int,
            p: int, packed: bool, args: tuple, operands: tuple = (),
            out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plans and launches C entry ``name``, counted under ``counter``:
    ``(x, w, *operands, counters, workspace, out, M, K, N, p, *args,
    vec_x, vec_w, bm, bk, kslice, smem, workspace ints)``."""
    m, k = x.shape
    pl = plan(m, k, n, p, packed, _sm_count(x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        _build.launch(name, x.device, x, w, *operands,
                      *_split_scratch(x.device, pl), out, m, k, n, p, *args,
                      _vec_ok(x, k), _vec_ok(w, n), pl.bm, pl.bk, pl.kslice,
                      pl.smem, pl.workspace)
        _build.LAUNCHES[counter] += 1
    return out


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
    return _launch("bitserial_matmul_s8", "bitserial_matmul", x, planes,
                   planes.shape[2], p, False, tuple(shifts) + (0,) * (4 - p))


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
    return _launch("packed_bitserial_matmul_u8", "packed_bitserial_matmul",
                   x, w_packed, w_packed.shape[1], eff // 2, True,
                   ((w_bits - eff) // 2, int(signed)))
