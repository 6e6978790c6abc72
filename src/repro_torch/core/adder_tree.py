"""Split-path CSA adder tree, functional model (port of
``repro.core.adder_tree``; paper §III-C, Fig. 6).

The column adder tree sums 64 3-bit signed products.  A carry-save tree
cannot sign-extend mid-reduction the way a binary adder tree (BAT) can, so
the paper splits the sum into two paths:

  * MSB path: the top bit of each 3-bit signed product weighs -2^2 = -4.
    The tree counts the set MSBs (a popcount) and the count is negated
    before the merge.
  * Low path: the bottom 2 bits are unsigned in [0, 3]; an unsigned CSA
    tree sums them.  The lowest 2 result bits pass straight through; the
    upper bits merge with the MSB path's result.

A column of unsigned weights keeps every MSB input at 0: the MSB path is
quiet (the power win of Table II).  Gate and energy costs live in
``repro_torch.hwmodel``.  Sums are int32, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def split_products(products: torch.Tensor):
    """Split 3-bit signed products (in [-4, 3]) into (msb_bits, low2)."""
    u = products.to(torch.int32) & 0b111     # 3-bit two's-complement pattern
    msb = (u >> 2) & 1                       # weight -4
    low2 = u & 0b11                          # unsigned [0, 3]
    return msb, low2


def csa_tree_sum(products: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sum 3-bit signed products via the split MSB / low-2-bit paths.
    Bit-exact with ``products.sum(axis)`` for inputs in [-4, 3]."""
    msb, low2 = split_products(products)
    msb_count = msb.sum(dim=axis, dtype=torch.int32)   # popcount of sign bits
    low_sum = low2.sum(dim=axis, dtype=torch.int32)    # unsigned CSA path
    # Merge: the low 2 bits of low_sum pass through; the upper bits add to
    # the negated MSB count.  Algebraically: low_sum - 4*msb_count.
    low_pass = low_sum & 0b11
    high = (low_sum >> 2) - msb_count
    return (high << 2) + low_pass


def msb_path_activity(products: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Fraction of nonzero MSB-path inputs (all zero for unsigned columns),
    f32: the unsigned-power saving the hwmodel prices.  The count times
    the f32 reciprocal of the row count, the reference's rounding (its
    compiler turns the mean's divide into that product)."""
    msb, _ = split_products(products)
    recip = float(np.float32(1.0) / np.float32(products.shape[axis]))
    return msb.to(torch.float32).sum(dim=axis) * recip
