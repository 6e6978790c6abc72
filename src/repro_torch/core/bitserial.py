"""Bit-serial MAC semantics (port of ``repro.core.bitserial``): a literal,
bit-exact model of paper Eq. (1).

    MAC = sum_c ( sum_t sum_r  A^r[t] * W_dcp^r[c] * (-1)^{SF} * 2^t ) * 2^{2c}

Activations stream LSB-first, one bit per cycle ``t``; ``SF`` marks the
sign-bit cycle of a signed activation (two's complement: the MSB weighs
-2^{N-1}).  Decomposed weight planes ``c`` combine spatially with shifts
2^{2c} (the 4-column group's shift-add in Fig. 5).

``torch.matmul`` has no int32 kernel on CUDA, so each cycle's column tree
(a 0/1 activation bit-plane times a weight plane in [-4, 3], summed over
the rows) runs as a float64 matmul: every partial sum is an integer far
below 2**53, hence exact in any summation order, on the CPU and on the
card alike.
"""
from __future__ import annotations

import torch

from repro_torch.core import decompose


def activation_bitplanes(a_int: torch.Tensor, a_bits: int, *,
                         signed: bool = True):
    """Split integer activations into LSB-first bit-planes.

    Returns (bits, weights): ``bits`` int8 {0,1} of shape (N, *a.shape);
    ``weights`` an int32 vector of per-plane arithmetic weights, where the
    sign-bit plane of a signed activation carries -2^{N-1} (Eq. (1)'s
    (-1)^{SF} factor folded in)."""
    u = a_int.to(torch.int32) & ((1 << a_bits) - 1)
    bits = torch.stack([(u >> t) & 1 for t in range(a_bits)]).to(torch.int8)
    weights = [1 << t for t in range(a_bits)]
    if signed:
        # SF cycle: the adder-tree output is negated before accumulation.
        weights[-1] = -weights[-1]
    return bits, torch.tensor(weights, dtype=torch.int32, device=a_int.device)


def _column_tree(a_bit: torch.Tensor, w_plane: torch.Tensor) -> torch.Tensor:
    """One cycle's column adder trees: sum over rows of (1-bit A) * W_dcp,
    exact (float64, see the module doc), as int32."""
    return torch.matmul(a_bit.to(torch.float64),
                        w_plane.to(torch.float64)).to(torch.int32)


def bitserial_mac(a_int: torch.Tensor, w_int: torch.Tensor, a_bits: int,
                  w_bits: int, *, a_signed: bool = True,
                  w_signed: bool = True) -> torch.Tensor:
    """Eq. (1) evaluated literally: bit-serial over t, plane-spatial over c.

    a_int: [..., R] integer activations (R = rows reduced over).
    w_int: [R, C] integer weights.
    Returns int32 [..., C], exactly equal to ``a_int @ w_int``."""
    planes = decompose.decompose_weights(w_int, w_bits, signed=w_signed)
    shifts = decompose.plane_shifts(w_bits, w_signed)
    bits, bit_weights = activation_bitplanes(a_int, a_bits, signed=a_signed)

    acc = torch.zeros(a_int.shape[:-1] + (w_int.shape[-1],),
                      dtype=torch.int32, device=a_int.device)
    for c, s in enumerate(shifts):           # spatial: one column per plane
        col_acc = torch.zeros_like(acc)
        for t in range(a_bits):              # temporal: one bit per cycle
            col_acc = col_acc + _column_tree(bits[t], planes[c]) \
                * bit_weights[t]
        acc = acc + (col_acc << s)           # group shift-add combine (Fig. 5)
    return acc


def cycles_per_mac(a_bits: int) -> int:
    """Bit-serial cycle count per MAC tile pass (one bit of A per clk cycle)."""
    return a_bits


def shift_add_clock_divider(a_bits: int) -> int:
    """clk_SA = clk / a_bits (paper §III-B lower-frequency shift-add domain)."""
    return a_bits
