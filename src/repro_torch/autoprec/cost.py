"""Hardware pricing of per-layer precision assignments (port of
``repro.autoprec.cost``).

The paper's search axis is the *accelerator*, not abstract bit counts: a
layer at ``w_bits`` occupies the PE array for ``w_bits/2`` plane passes at
an ``a_bits``-deep bit-serial activation stream, so the cost of a candidate
assignment is its modeled **cycles per decoded token** (and joules, via the
calibrated Table-III energy model) — not the parameter-weighted average
bitwidth HAWQ-style allocators optimize.  :class:`CostModel` binds one
model's per-layer MAC workload (``ArchConfig.quant_layer_macs``) to the
hwmodel's vectorized per-layer pricing (``hwmodel.energy.per_layer_cost``)
so the search strategies in :mod:`repro_torch.autoprec.search` optimize
the hardware axis directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import numpy.typing as npt

from repro_torch.hwmodel import energy

# A precision assignment: layer name -> effective weight width.
Assignment = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices per-layer weight-width assignments for one model workload.

    ``macs`` maps every quantizable layer name to its MACs per decoded
    token (period multiplicity and routed-expert counts already folded in
    — see ``ArchConfig.quant_layer_macs``); ``a_bits`` is the uniform
    activation width the engine serves at (the weight width is the
    per-layer search variable, matching the runtime plane-prefix path
    where only ``w_bits`` varies per layer)."""

    macs: Dict[str, int]
    a_bits: int = 8

    @classmethod
    def for_config(cls, cfg: Any, a_bits: int = 8) -> "CostModel":
        """Cost model for an ``ArchConfig`` (its quantizable projections)."""
        return cls(macs=dict(cfg.quant_layer_macs()), a_bits=a_bits)

    @property
    def layers(self) -> Tuple[str, ...]:
        return tuple(self.macs)

    @property
    def total_macs(self) -> float:
        return float(sum(self.macs.values()))

    def _bits_vector(self, assignment: Assignment) -> npt.NDArray[np.int64]:
        missing = [n for n in self.macs if n not in assignment]
        if missing:
            raise KeyError(f"assignment misses layers {missing}")
        unknown = [n for n in assignment if n not in self.macs]
        if unknown:
            raise KeyError(f"assignment names unknown layers {unknown}")
        return np.asarray([assignment[n] for n in self.macs], np.int64)

    def layer_cycles(self, name: str, w_bits: int) -> float:
        """Cycles per token one layer costs at one width (the marginal
        quantity the greedy search trades against divergence)."""
        return self.macs[name] * energy.cycles_per_mac(w_bits, self.a_bits)

    def cycles_per_token(self, assignment: Assignment) -> float:
        """Modeled array cycles per decoded token under ``assignment``."""
        bits = self._bits_vector(assignment)
        macs = np.asarray([self.macs[n] for n in self.macs], np.float64)
        return float(energy.per_layer_cost(macs, bits,
                                           self.a_bits)["cycles"].sum())

    def energy_per_token_j(self, assignment: Assignment) -> float:
        """Modeled joules per decoded token under ``assignment``."""
        bits = self._bits_vector(assignment)
        macs = np.asarray([self.macs[n] for n in self.macs], np.float64)
        return float(energy.per_layer_cost(macs, bits,
                                           self.a_bits)["energy_j"].sum())

    def uniform_cycles(self, w_bits: int) -> float:
        """Cycles per token with every layer at ``w_bits`` (the uniform
        baseline the searched Pareto front must dominate)."""
        return self.cycles_per_token({n: w_bits for n in self.macs})

    def average_bits(self, assignment: Assignment) -> float:
        """MAC-weighted mean weight width (reported alongside cycles; NOT
        the optimization objective — two assignments with equal average
        bits can differ in cycles when their widths sit on layers of very
        different MAC weight)."""
        bits = self._bits_vector(assignment)
        macs = np.asarray([self.macs[n] for n in self.macs], np.float64)
        return float((macs * bits).sum() / macs.sum())
