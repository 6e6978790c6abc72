"""The modeled accelerator's throughput, power and energy (§IV: Table III,
Fig. 8) and the per-tier cycle pricing built on them (port of
``repro.hwmodel.energy``, the whole module).

Every figure here is the paper's 28 nm, 64x64 array's, modeled: a TOPS or
TOPS/W value is never a speed of the device that runs the port.

Throughput is derived from the architecture (``core.pe_array.peak_tops``:
plane count, column grouping, bit-serial cycles).  Power is a
4-coefficient linear model over structural features (accumulator width,
multi-plane combine activity, shift-add clock ratio) solved exactly
against the paper's four measured PE-array efficiency points at 0.72 V /
500 MHz:

    8/8: 14   4/4: 52.1   3/3: 139.8   2/2: 205.8   TOPS/W

The implied array power is ~9.1-9.9 mW across ALL precision modes: the
efficiency scaling is almost purely the ops/cycle scaling of the weight
combination, the paper's central claim.  Accelerator-level numbers apply
one overhead factor (buffers + control): the paper's own three points give
14/4.69 = 52.1/17.45 = 205.8/68.94 = 2.985.

Pricing: a MAC at an effective ``(w_bits, a_bits)`` occupies the array for
``a_bits / (rows * logical columns per pass)`` cycles — activations stream
one bit a cycle, and a narrower weight packs more logical columns into the
64 physical ones.  ``tier_cycles_per_token``, ``relative_tier_costs`` and
``fastest_tier`` price a ``PrecisionSchedule``'s tiers for
``serve.scheduler.SLOPolicy`` and the telemetry; ``per_layer_cost`` prices
a per-layer assignment for ``autoprec``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import numpy.typing as npt

from repro_torch.core import decompose, pe_array

CAL_VOLTAGE = 0.72
CAL_FREQ_MHZ = 500.0
CAL_TOGGLE = 0.5              # 50 % weight sparsity in §IV
PEAK_VOLTAGE = 1.05
PEAK_FREQ_MHZ = 1000.0

PAPER_PE_EFF = {(8, 8): 14.0, (4, 4): 52.1, (3, 3): 139.8, (2, 2): 205.8}
PAPER_ACCEL_EFF = {(8, 8): 4.69, (4, 4): 17.45, (2, 2): 68.94}
PAPER_PEAK_TOPS = 4.09
ACCEL_OVERHEAD = 2.985        # buffers/NoC/control power factor (see above)
STATIC_FRACTION = 0.12        # leakage share at the calibration point

_CFG = pe_array.PEArrayConfig(clk_mhz=CAL_FREQ_MHZ)


def tops(w_bits: int, a_bits: int, *, freq_mhz: float = CAL_FREQ_MHZ) -> float:
    cfg = dataclasses.replace(_CFG, clk_mhz=freq_mhz)
    return float(pe_array.peak_tops(cfg, w_bits, a_bits))


def _features(w_bits: int, a_bits: int) -> npt.NDArray[np.float64]:
    acc_width = (w_bits + a_bits + 6) / 16.0       # +log2(64 rows)
    multi_plane = 1.0 if decompose.num_planes(w_bits) > 1 else 0.0
    return np.array([1.0, acc_width, multi_plane, 1.0 / a_bits])


def _solve_power_coeffs() -> npt.NDArray[np.float64]:
    pts = sorted(PAPER_PE_EFF)
    feats = np.stack([_features(w, a) for w, a in pts])
    targets = np.array([tops(w, a) / PAPER_PE_EFF[(w, a)] for w, a in pts])
    return np.linalg.solve(feats, targets)


_COEFFS = _solve_power_coeffs()


def pe_power_w(w_bits: int, a_bits: int, *, toggle: float = CAL_TOGGLE,
               voltage: float = CAL_VOLTAGE,
               freq_mhz: float = CAL_FREQ_MHZ) -> float:
    """Array power in watts; V^2*f dynamic scaling + toggle-rate scaling."""
    p_cal = float(_features(w_bits, a_bits) @ _COEFFS)
    p_static = STATIC_FRACTION * p_cal
    p_dyn = (p_cal - p_static) * (toggle / CAL_TOGGLE)
    vf = (voltage / CAL_VOLTAGE) ** 2 * (freq_mhz / CAL_FREQ_MHZ)
    return p_dyn * vf + p_static * (voltage / CAL_VOLTAGE)


def pe_efficiency(w_bits: int, a_bits: int, *, toggle: float = CAL_TOGGLE,
                  voltage: float = CAL_VOLTAGE,
                  freq_mhz: float = CAL_FREQ_MHZ) -> float:
    """TOPS/W of the PE array."""
    return tops(w_bits, a_bits, freq_mhz=freq_mhz) / pe_power_w(
        w_bits, a_bits, toggle=toggle, voltage=voltage, freq_mhz=freq_mhz)


def accelerator_efficiency(w_bits: int, a_bits: int, **kw: float) -> float:
    return pe_efficiency(w_bits, a_bits, **kw) / ACCEL_OVERHEAD


def peak_throughput_tops() -> float:
    """Peak accelerator throughput: 2/2-bit @ 1 GHz (paper: 4.09)."""
    return tops(2, 2, freq_mhz=PEAK_FREQ_MHZ)


def energy_per_mac_j(w_bits: int, a_bits: int, *, accelerator: bool = True,
                     **kw: float) -> float:
    eff = accelerator_efficiency(w_bits, a_bits, **kw) if accelerator \
        else pe_efficiency(w_bits, a_bits, **kw)
    return 2.0 / (eff * 1e12)          # 2 ops per MAC


def fig8_curve(w_bits: int, a_bits: int,
               toggles: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5,
                                           0.6, 0.7, 0.8, 0.9)
               ) -> Dict[float, float]:
    """Energy efficiency vs input toggle rate (Fig 8 family of curves)."""
    return {t: pe_efficiency(w_bits, a_bits, toggle=t) for t in toggles}


def table3_ours() -> Dict[str, float]:
    return {
        "tech_nm": 28.0,
        "area_mm2": 0.75,
        "freq_mhz": PEAK_FREQ_MHZ,
        "peak_tops": peak_throughput_tops(),
        "eff_8bit": accelerator_efficiency(8, 8),
        "eff_4bit": accelerator_efficiency(4, 4),
        "eff_2bit": accelerator_efficiency(2, 2),
    }


# ------------------------------------------------------- runtime tier costs
def tier_cost(w_bits: int, a_bits: int, *, freq_mhz: float = CAL_FREQ_MHZ,
              toggle: float = CAL_TOGGLE) -> Dict[str, float]:
    """Cycle/energy cost of serving at an EFFECTIVE precision: a request's
    tier, not the stored 8-bit superplane, sets the work (``w_bits/2``
    plane passes at an ``a_bits``-deep bit-serial activation stream)."""
    return {
        "plane_passes": float(decompose.num_planes(w_bits)),
        "bitserial_depth": float(a_bits),
        "cycles_per_mac": cycles_per_mac(w_bits, a_bits, freq_mhz=freq_mhz),
        "effective_tops": tops(w_bits, a_bits, freq_mhz=freq_mhz),
        "tops_per_w": pe_efficiency(w_bits, a_bits, toggle=toggle,
                                    freq_mhz=freq_mhz),
        "energy_per_mac_j": energy_per_mac_j(w_bits, a_bits, toggle=toggle,
                                             freq_mhz=freq_mhz),
    }


def precision_tier_table(tiers: Dict[str, Tuple[int, int]],
                         **kw: float) -> Dict[str, Dict[str, float]]:
    """Per-tier cost table for ``{tier_name: (w_bits, a_bits)}``."""
    return {name: tier_cost(w, a, **kw) for name, (w, a) in tiers.items()}


@functools.lru_cache(maxsize=None)
def cycles_per_mac(w_bits: int, a_bits: int, *,
                   freq_mhz: float = CAL_FREQ_MHZ) -> float:
    """Array cycles one MAC occupies at an effective (w_bits, a_bits)
    (cached: the search prices thousands of assignments against a handful
    of operating points)."""
    cfg = dataclasses.replace(_CFG, clk_mhz=freq_mhz)
    n_logical, _ = pe_array.logical_columns_per_pass(cfg, w_bits)
    return float(a_bits) / (float(cfg.rows) * float(n_logical))


@functools.lru_cache(maxsize=None)
def _energy_per_mac_cached(w_bits: int, a_bits: int) -> float:
    return energy_per_mac_j(w_bits, a_bits)


def per_layer_cost(mac_counts: Sequence[float],
                   w_bits: Sequence[int],
                   a_bits: int) -> Dict[str, npt.NDArray[np.float64]]:
    """Vectorized per-layer pricing of one precision assignment:
    ``mac_counts[i]`` MACs at ``w_bits[i]`` (activations at ``a_bits``)
    cost ``cycles[i]`` array cycles and ``energy_j[i]`` joules.  Distinct
    operating points are priced once and broadcast (the inner loop of
    ``autoprec.search``)."""
    macs = np.asarray(mac_counts, np.float64)
    wb = np.asarray(w_bits, np.int64)
    if macs.shape != wb.shape:
        raise ValueError(f"mac_counts {macs.shape} and w_bits {wb.shape} "
                         "must align")
    cyc = np.empty_like(macs)
    enj = np.empty_like(macs)
    for b in np.unique(wb):
        m = wb == b
        cyc[m] = cycles_per_mac(int(b), a_bits)
        enj[m] = _energy_per_mac_cached(int(b), a_bits)
    return {"cycles": macs * cyc, "energy_j": macs * enj}


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


def speculative_cycles_per_token(accept_rate: float, k: int,
                                 draft_cost: float,
                                 verify_cost: float) -> float:
    """Modeled cycles per EMITTED token of one self-speculative round:
    ``(k * draft_cost + W_v) / (E + 1)`` with ``E = sum_{i=1..k} a^i``
    under i.i.d. acceptance at rate ``a``, and ``W_v`` the verify window's
    cost: one ``verify_cost`` for the weight-plane passes plus the k extra
    positions' activation work at half a position each.  Costs in the
    units of :func:`relative_tier_costs`."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], got {accept_rate}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if draft_cost <= 0.0 or verify_cost <= 0.0:
        raise ValueError("tier costs must be positive")
    expected_accepted = sum(accept_rate ** i for i in range(1, k + 1))
    act_marginal = 0.5          # bit-serial activation share of a position
    verify_window = verify_cost * (1.0 + act_marginal * k)
    round_cycles = k * draft_cost + verify_window
    return round_cycles / (expected_accepted + 1.0)


# Published comparison rows (Table III), scaled-to-28nm values as printed.
TABLE3_OTHERS = {
    "TVLSI22_bitparallel": {"peak_tops": 4.12, "eff_8bit": 3.62,
                            "eff_4bit": 12.13, "eff_2bit": 22.89},
    "UNPU_JSSC18": {"peak_tops": 7.372, "eff_16bit": 7.15, "eff_4bit": 26.93},
    "BitSystolic_TCASI20": {"peak_tops": 0.403, "eff_8bit": 3.95,
                            "eff_4bit": 15.79, "eff_2bit": 61.98},
}


def improvement_vs_bitsystolic() -> Dict[str, float]:
    """Paper claims +18.7 % / +10.5 % / +11.2 % at 8/4/2-bit."""
    ours = table3_ours()
    bs = TABLE3_OTHERS["BitSystolic_TCASI20"]
    return {
        "8bit": ours["eff_8bit"] / bs["eff_8bit"] - 1.0,
        "4bit": ours["eff_4bit"] / bs["eff_4bit"] - 1.0,
        "2bit": ours["eff_2bit"] / bs["eff_2bit"] - 1.0,
    }
