"""Per-tier cycle pricing of the paper's PE array (port of the pricing
half of ``repro.hwmodel.energy``: ``cycles_per_mac``,
``tier_cycles_per_token``, ``relative_tier_costs`` and ``fastest_tier``).
The energy and power model is ROADMAP Queue 1 item 9.

A MAC at an effective ``(w_bits, a_bits)`` occupies the array for
``a_bits / (rows * logical columns per pass)`` cycles: activations stream
one bit a cycle, and a narrower weight packs more logical columns into
the 64 physical ones (``core.pe_array``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

from repro_torch.core import pe_array

_CFG = pe_array.PEArrayConfig()


@functools.lru_cache(maxsize=None)
def cycles_per_mac(w_bits: int, a_bits: int) -> float:
    """Array cycles one MAC occupies at an effective (w_bits, a_bits)."""
    n_logical, _ = pe_array.logical_columns_per_pass(_CFG, w_bits)
    return float(a_bits) / (float(_CFG.rows) * float(n_logical))


def tier_cycles_per_token(schedule: Any,
                          mac_counts: Optional[Mapping[str, float]] = None
                          ) -> Dict[str, float]:
    """Modeled array cycles of each tier of a ``PrecisionSchedule``: per
    token, MAC-weighted over the layers through ``schedule.lookup`` when
    ``mac_counts`` (layer name -> MACs per token) is given, else the
    cycles per MAC of the tier's default operating point."""
    raw: Dict[str, float] = {}
    for t in schedule.tier_names:
        if mac_counts:
            raw[t] = sum(
                float(m) * cycles_per_mac(int(prec.w_bits),
                                          int(prec.a_bits))
                for name, m in mac_counts.items()
                for prec in (schedule.lookup(name, t),))
        else:
            w, a = schedule.tier_bits(t)
            raw[t] = cycles_per_mac(int(w), int(a))
    return raw


def relative_tier_costs(schedule: Any,
                        mac_counts: Optional[Mapping[str, float]] = None
                        ) -> Dict[str, float]:
    """Per-token service cost of each tier, the cheapest at 1.0 — the price
    list of ``serve.scheduler.SLOPolicy`` (see :func:`tier_cycles_per_token`
    for the two pricing rules)."""
    raw = tier_cycles_per_token(schedule, mac_counts)
    floor = min(raw.values())
    return {name: c / floor for name, c in raw.items()}


def fastest_tier(schedule: Any,
                 mac_counts: Optional[Mapping[str, float]] = None) -> str:
    """The cheapest tier under :func:`relative_tier_costs`; ties break on
    the name."""
    costs = relative_tier_costs(schedule, mac_counts)
    return min(sorted(costs), key=lambda t: costs[t])
