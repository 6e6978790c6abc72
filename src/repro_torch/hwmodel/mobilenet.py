"""MobileNetV2 workload model — the paper's own benchmark (§IV): mixed
precision cuts inference power 35.2 % vs a fixed 8-bit model (port of
``repro.hwmodel.mobilenet``).

The paper does not publish its per-layer bit map, so we reproduce the
*mechanism*: per-layer MAC counts from the standard MobileNetV2 config, the
framework's sensitivity-based allocator choosing per-layer bits under an
average-bit budget, and the hwmodel energy-per-MAC.  The benchmark sweeps
the budget and reports the budget at which the 35.2 % reduction is matched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.hwmodel import energy

# (expansion t, out channels c, repeats n, stride s) — Sandler et al. 2018.
_INVERTED_RESIDUALS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


@dataclasses.dataclass
class ConvLayer:
    name: str
    kind: str          # first | dw | pw | head | fc
    macs: int
    params: int


def mobilenet_v2_layers(input_res: int = 224) -> List[ConvLayer]:
    layers: List[ConvLayer] = []
    res = input_res // 2
    cin = 32
    layers.append(ConvLayer("conv_first", "first",
                            3 * 3 * 3 * 32 * res * res, 3 * 3 * 3 * 32))
    idx = 0
    for t, c, n, s in _INVERTED_RESIDUALS:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                layers.append(ConvLayer(f"b{idx}_expand", "pw",
                                        cin * hidden * res * res, cin * hidden))
            res_out = res // stride
            layers.append(ConvLayer(f"b{idx}_dw", "dw",
                                    3 * 3 * hidden * res_out * res_out,
                                    3 * 3 * hidden))
            layers.append(ConvLayer(f"b{idx}_project", "pw",
                                    hidden * c * res_out * res_out, hidden * c))
            cin, res = c, res_out
            idx += 1
    layers.append(ConvLayer("conv_head", "head",
                            cin * 1280 * res * res, cin * 1280))
    layers.append(ConvLayer("fc", "fc", 1280 * 1000, 1280 * 1000))
    return layers


def total_macs(layers: Optional[List[ConvLayer]] = None) -> int:
    return sum(l.macs for l in (layers or mobilenet_v2_layers()))


def allocate_bits(avg_bits: float,
                  layers: Optional[List[ConvLayer]] = None) -> Dict[str, int]:
    """Sensitivity-based per-layer bits via core.policy: first/last layers and
    depthwise convs are precision-critical (HAWQ-style folklore encoded as
    the sensitivity prior: sensitivity ~ 1/params, boosted for first/dw/fc)."""
    from repro_torch.core.policy import allocate_bits_by_sensitivity
    layers = layers or mobilenet_v2_layers()
    sens: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for l in layers:
        # The allocator's greedy core prices promotions PER BUDGET UNIT
        # (params x bits), so the 1/params weighting is built in; the
        # prior only carries the kind boost.
        boost = 8.0 if l.kind in ("first", "fc", "dw") else 1.0
        sens[l.name] = boost * 1e6
        counts[l.name] = l.params
    policy = allocate_bits_by_sensitivity(sens, counts, avg_bits,
                                          choices=(2, 3, 4, 5, 6, 8))
    return {l.name: int(policy.lookup(l.name).w_bits) for l in layers}


def inference_energy_j(bits: Dict[str, int],
                       layers: Optional[List[ConvLayer]] = None) -> float:
    layers = layers or mobilenet_v2_layers()
    return sum(l.macs * energy.energy_per_mac_j(bits[l.name], bits[l.name])
               for l in layers)


def power_reduction_vs_8bit(avg_bits: float) -> float:
    """Fractional energy-per-inference reduction vs fixed 8/8-bit
    (iso-frame-rate, so energy ratio == power ratio)."""
    layers = mobilenet_v2_layers()
    bits = allocate_bits(avg_bits, layers)
    e_mixed = inference_energy_j(bits, layers)
    e_8bit = sum(l.macs * energy.energy_per_mac_j(8, 8) for l in layers)
    return 1.0 - e_mixed / e_8bit


PAPER_REDUCTION = 0.352


def inference_cycles(bits: Dict[str, int],
                     layers: Optional[List[ConvLayer]] = None,
                     rows: int = 64, cols: int = 64) -> int:
    """Array cycles per inference from the PE-array occupancy model:
    each layer's MACs map onto rows x logical-columns at a_bits cycles/pass
    (weight-stationary; systolic fill ignored as in §IV)."""
    from repro_torch.core.pe_array import PEArrayConfig, logical_columns_per_pass
    cfg = PEArrayConfig(rows=rows, cols=cols)
    total = 0
    for l in (layers or mobilenet_v2_layers()):
        b = bits[l.name]
        n_logical, _ = logical_columns_per_pass(cfg, b)
        macs_per_cycle = rows * n_logical / b      # a_bits == w_bits (§IV)
        total += int(l.macs / macs_per_cycle)
    return total


def inference_fps(bits: Dict[str, int], clk_mhz: float = 500.0) -> float:
    return clk_mhz * 1e6 / inference_cycles(bits)


def throughput_speedup_vs_8bit(avg_bits: float) -> float:
    layers = mobilenet_v2_layers()
    mixed = allocate_bits(avg_bits, layers)
    fixed8 = {l.name: 8 for l in layers}
    return inference_fps(mixed) / inference_fps(fixed8)
