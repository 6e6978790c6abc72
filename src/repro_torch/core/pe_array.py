"""Functional simulator of the paper's 64x64 weight-stationary PE array
(port of ``repro.core.pe_array``).

Bit-exact model of the microarchitecture (§III, Figs. 2-5):

  * weights preloaded top-to-bottom, decomposed per Table I
    (``core.decompose``);
  * activations stream LSB-first, 1 bit a cycle (``core.bitserial``);
  * per-cycle row reduction through the split-path CSA tree
    (``core.adder_tree``);
  * sign-bit cycle negation (Eq. (1)'s (-1)^{SF});
  * 4-column-group shift-add combine at clk_SA = clk / a_bits (Fig. 5);
  * Fig. 4's independent shift-add paths for the 3-plane (6/7-bit) case,
    which lift the array's utilization from 48/64 to 63/64 columns.

The statistics are the modeled 28 nm array's (cycles, MACs a cycle, TOPS
at ``clk_mhz``: 4.09 TOPS peak at 2/2-bit, 64*64/2 MACs a cycle * 2 ops *
1 GHz), not a speed of the device the simulation runs on.  The tier
pricing (``hwmodel.energy.cycles_per_mac``) reads
:func:`logical_columns_per_pass`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import adder_tree, bitserial, decompose


@dataclasses.dataclass(frozen=True)
class PEArrayConfig:
    rows: int = 64
    cols: int = 64
    group: int = 4
    clk_mhz: float = 1000.0
    # Fig. 4: five extra cross-group shift-add paths for the 3-plane case.
    independent_shift_add: bool = True


def logical_columns_per_pass(cfg: PEArrayConfig, w_bits: int,
                             signed: bool = True) -> tuple[int, int]:
    """(logical output columns per array pass, idle physical columns)."""
    p = decompose.num_planes(w_bits, signed)
    if p == 3:
        if cfg.independent_shift_add:
            n = cfg.cols // p                    # 21 logical, 1 idle (Fig. 4)
            return n, cfg.cols - n * p
        per_group = cfg.group // p               # 1 logical, 1 idle per group
        groups = cfg.cols // cfg.group
        return per_group * groups, groups * (cfg.group - per_group * p)
    per_group = cfg.group // p
    groups = cfg.cols // cfg.group
    return per_group * groups, groups * (cfg.group - per_group * p)


def array_utilization(cfg: PEArrayConfig, w_bits: int,
                      signed: bool = True) -> float:
    _, idle = logical_columns_per_pass(cfg, w_bits, signed)
    return 1.0 - idle / cfg.cols


@dataclasses.dataclass
class PEArrayStats:
    w_bits: int
    a_bits: int
    row_tiles: int
    col_passes: int
    cycles: int
    macs: int
    utilization: float

    @property
    def macs_per_cycle(self) -> float:
        return self.macs / max(self.cycles, 1)

    def tops(self, clk_mhz: float) -> float:
        """2 ops (mul+add) per MAC at the given clock."""
        return 2.0 * self.macs_per_cycle * clk_mhz * 1e6 / 1e12


def pe_array_matmul(a_int: torch.Tensor, w_int: torch.Tensor, *,
                    w_bits: int, a_bits: int, a_signed: bool = True,
                    w_signed: bool = True,
                    cfg: PEArrayConfig = PEArrayConfig()):
    """Simulate ``a_int @ w_int`` on the array, bit-exact at any R/C
    (tiled): row tiles x planes x activation bits, each step's products
    reduced by :func:`adder_tree.csa_tree_sum`.

    a_int: [B, R] integer activations; w_int: [R, C] integer weights, on
    one device.  Returns (int32 [B, C], PEArrayStats)."""
    b, r = a_int.shape
    r2, c = w_int.shape
    if r != r2:
        raise ValueError(f"pe_array_matmul: a has {r} rows, w {r2}")
    shifts = decompose.plane_shifts(w_bits, w_signed)
    n_logical, _ = logical_columns_per_pass(cfg, w_bits, w_signed)

    planes = decompose.decompose_weights(w_int, w_bits, signed=w_signed)
    bits, bit_w = bitserial.activation_bitplanes(a_int, a_bits,
                                                 signed=a_signed)

    out = torch.zeros((b, c), dtype=torch.int32, device=a_int.device)
    row_tiles = math.ceil(r / cfg.rows)
    for rt in range(row_tiles):
        r0, r1 = rt * cfg.rows, min((rt + 1) * cfg.rows, r)
        for plane_idx, s in enumerate(shifts):
            w_plane = planes[plane_idx, r0:r1].to(torch.int32)    # [r_t, C]
            col_acc = torch.zeros((b, c), dtype=torch.int32,
                                  device=a_int.device)
            for t in range(a_bits):
                a_bit = bits[t, :, r0:r1].to(torch.int32)         # [B, r_t]
                # 3-bit signed products, reduced by the split-path CSA tree.
                prods = a_bit[:, :, None] * w_plane[None, :, :]   # [B, r_t, C]
                col_acc = col_acc + adder_tree.csa_tree_sum(prods, axis=1) \
                    * bit_w[t]                                    # SF folded in
            out = out + (col_acc << s)                            # group combine

    col_passes = math.ceil(c / n_logical)
    # One activation vector takes a_bits cycles per (row tile x column
    # pass); B vectors pipeline back to back (systolic fill ignored).
    cycles = row_tiles * col_passes * a_bits * b
    stats = PEArrayStats(
        w_bits=w_bits, a_bits=a_bits, row_tiles=row_tiles,
        col_passes=col_passes, cycles=cycles, macs=b * r * c,
        utilization=array_utilization(cfg, w_bits, w_signed))
    return out, stats


def peak_tops(cfg: PEArrayConfig, w_bits: int, a_bits: int) -> float:
    """Peak throughput of the modeled array at a precision pair (paper:
    4.09 TOPS at 2/2-bit, 64x64 at 1 GHz)."""
    n_logical, _ = logical_columns_per_pass(cfg, w_bits)
    macs_per_cycle = cfg.rows * n_logical / a_bits
    return 2.0 * macs_per_cycle * cfg.clk_mhz * 1e6 / 1e12
