"""PE-array area/power breakdown (Fig 7) from structural gate-equivalent
counts (port of ``repro.hwmodel.breakdown``).  Validates the paper's
headline: the Fig-4 independent shift-add paths for 6/7-bit operation
cost only ~0.97 % of PE-array area.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.hwmodel.adder_tree_cost import (GE_FA, GE_HA, GE_REG_BIT,
                                           SHARED_OVERHEAD_GE,
                                           csa_split_cost)

ROWS, COLS, GROUPS = 64, 64, 16

# Per-unit gate-equivalent estimates (28 nm std-cell ballpark, documented).
GE_MULT_3B = 8.0        # 3-bit x 1-bit multiplier (gated ANDs + sign ext)
GE_W_REG = 3 * GE_REG_BIT     # 3-bit weight register per PE
GE_ACT_PIPE = 1 * GE_REG_BIT  # systolic activation pipeline bit per PE
ACC_BITS = 24
GE_SHIFTER = 18.0       # two-case configurable shifter (Table I)
SA_BITS = 12
GE_SA_PATH = 2 * GE_SHIFTER + SA_BITS * GE_FA + SA_BITS * GE_REG_BIT
GE_INDEP_PATH = GE_SA_PATH + 276.0   # Fig-4 path + cross-group routing/muxes


def area_breakdown() -> Dict[str, float]:
    tree = csa_split_cost(ROWS)
    areas = {
        "multipliers": ROWS * COLS * GE_MULT_3B,
        "weight_regs": ROWS * COLS * GE_W_REG,
        "act_pipeline": ROWS * COLS * GE_ACT_PIPE,
        "adder_trees": COLS * (tree.area_ge + SHARED_OVERHEAD_GE),
        "accumulators": COLS * ACC_BITS * (GE_FA + GE_REG_BIT),
        "shift_add": GROUPS * 3 * GE_SA_PATH / 2,   # shifters #0/#1/#2 (Fig 5)
        "indep_shift_add": 5 * GE_INDEP_PATH,       # Fig 4 (6/7-bit mode)
    }
    return areas


def area_fractions() -> Dict[str, float]:
    a = area_breakdown()
    tot = sum(a.values())
    return {k: v / tot for k, v in a.items()}


def indep_path_fraction() -> float:
    """Paper: 0.97 % of PE-array area."""
    return area_fractions()["indep_shift_add"]


PAPER_INDEP_FRACTION = 0.0097


def power_breakdown(w_bits: int = 8, a_bits: int = 8) -> Dict[str, float]:
    """Relative dynamic power by component at 8/8-bit (Fig 7b shape):
    activity-weighted areas (registers toggle every cycle, multipliers at
    the input toggle rate, shift-add at clk/a)."""
    a = area_breakdown()
    act = {
        "multipliers": 0.5, "weight_regs": 0.05, "act_pipeline": 1.0,
        "adder_trees": 0.6, "accumulators": 1.0,
        "shift_add": 1.0 / a_bits, "indep_shift_add": 0.0,
    }
    p = {k: a[k] * act[k] for k in a}
    tot = sum(p.values())
    return {k: v / tot for k, v in p.items()}
