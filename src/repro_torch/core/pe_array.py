"""The paper's 64x64 weight-stationary PE array (port of
``repro.core.pe_array``): its configuration and how many logical output
columns one array pass yields at a weight width — the part the tier
pricing reads (``hwmodel.energy.cycles_per_mac``).  The bit-exact array
simulator is ROADMAP Queue 1 item 9."""
from __future__ import annotations

import dataclasses

from repro_torch.core import decompose


@dataclasses.dataclass(frozen=True)
class PEArrayConfig:
    rows: int = 64
    cols: int = 64
    group: int = 4
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
