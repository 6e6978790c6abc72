"""Per-layer mixed-precision policy (port of ``repro.core.policy``).

Backend names and their counterparts in the JAX package:

    port          repro (JAX)    what runs
    dense         dense          bf16 matmul, no quantization
    fake_quant    fake_quant     quantize-dequantize, dense matmul
    decomposed    decomposed     integer plane-decomposed matmul, plain torch
    cuda          pallas         the hand-written Hopper kernels
                                 (kernels/csrc/*.cu); their plain versions
                                 on CPU tensors

A schedule file written by the JAX package names ``pallas`` where the port
names ``cuda``; reading or writing one maps between the two names.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Optional

from repro_torch.core.decompose import RUNTIME_W_BITS

BACKENDS = ("dense", "fake_quant", "decomposed", "cuda")
INTEGER_BACKENDS = ("decomposed", "cuda")
# The port's backend name -> the JAX package's, for schedule files.
JAX_BACKEND_NAME = {"dense": "dense", "fake_quant": "fake_quant",
                    "decomposed": "decomposed", "cuda": "pallas"}


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """One layer's (w_bits, a_bits, signedness, backend) operating point.
    Frozen and hashable: precisions key the grouped-matmul layouts."""

    w_bits: int = 8
    a_bits: int = 8
    w_signed: bool = True
    a_signed: bool = True
    backend: str = "fake_quant"

    def __post_init__(self):
        if not (2 <= self.w_bits <= 8 and 2 <= self.a_bits <= 8):
            raise ValueError(f"bits out of 2..8: w={self.w_bits} a={self.a_bits}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")

    def with_backend(self, backend: str) -> "LayerPrecision":
        """This precision with the execution backend swapped."""
        return dataclasses.replace(self, backend=backend)


DEFAULT_PRECISION = LayerPrecision()


@dataclasses.dataclass
class PrecisionPolicy:
    """Maps layer names (glob patterns) to LayerPrecision; the first
    matching rule wins, ``default`` applies otherwise.  Layer names are the
    reference's, e.g. ``layers.pos0.attn.q_proj`` or ``lm_head``."""

    rules: Dict[str, LayerPrecision] = dataclasses.field(default_factory=dict)
    default: LayerPrecision = DEFAULT_PRECISION

    def lookup(self, name: str) -> LayerPrecision:
        for pattern, prec in self.rules.items():
            if fnmatch.fnmatch(name, pattern):
                return prec
        return self.default

    def with_backend(self, backend: str) -> "PrecisionPolicy":
        """Every rule and the default re-targeted to ``backend``."""
        return PrecisionPolicy(
            rules={k: v.with_backend(backend) for k, v in self.rules.items()},
            default=self.default.with_backend(backend))


def uniform_policy(w_bits: int, a_bits: int, backend: str = "fake_quant",
                   a_signed: bool = True) -> PrecisionPolicy:
    """Single-precision policy: every layer at (w_bits, a_bits)."""
    return PrecisionPolicy(default=LayerPrecision(
        w_bits=w_bits, a_bits=a_bits, backend=backend, a_signed=a_signed))


# Per-request KV-cache precision tiers: None (bf16), 8 (int8), 4 (int4).
KV_TIER_CHOICES = (None, 8, 4)


@dataclasses.dataclass
class PrecisionSchedule:
    """Named runtime tiers over one preloaded superplane weight store.

    ``tiers`` maps tier name -> that tier's default LayerPrecision;
    ``rules`` optionally refines single tiers per layer-name glob (first
    match wins).  All precisions share ``w_signed`` and use an integer
    serving backend with an even, plane-truncatable ``w_bits``.
    ``kv_tiers`` optionally maps tier -> KV-cache precision (None = bf16,
    8, 4; tiers left out are bf16): a tiered engine then keeps ONE mixed
    per-slot KV arena whose slots store K/V at their request's tier's
    precision (``models.layers.KVCache``)."""

    tiers: Dict[str, LayerPrecision]
    rules: Dict[str, Dict[str, LayerPrecision]] = dataclasses.field(
        default_factory=dict)
    default_tier: Optional[str] = None
    kv_tiers: Optional[Dict[str, Optional[int]]] = None

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("a PrecisionSchedule needs at least one tier")
        if self.default_tier is None:
            self.default_tier = next(iter(self.tiers))
        if self.default_tier not in self.tiers:
            raise ValueError(f"default tier {self.default_tier!r} not in "
                             f"{sorted(self.tiers)}")
        for t in self.rules:
            if t not in self.tiers:
                raise ValueError(f"rules for unknown tier {t!r}")
        if self.kv_tiers is not None:
            for t, kb in self.kv_tiers.items():
                if t not in self.tiers:
                    raise ValueError(f"kv_tiers for unknown tier {t!r}")
                if kb not in KV_TIER_CHOICES:
                    raise ValueError(
                        f"kv tier must be one of {KV_TIER_CHOICES} "
                        f"(None = bf16), got {kb!r} for tier {t!r}")
        signs = set()
        for prec in self._all_precisions():
            if prec.backend not in INTEGER_BACKENDS:
                raise ValueError(
                    f"tier backend must be an integer serving backend, got "
                    f"{prec.backend!r}")
            if prec.w_bits not in RUNTIME_W_BITS:
                raise ValueError(
                    f"tier w_bits must be plane-truncatable {RUNTIME_W_BITS},"
                    f" got {prec.w_bits}")
            signs.add(prec.w_signed)
        if len(signs) > 1:
            raise ValueError("all tiers must share w_signed: the sign mode "
                             "is baked into the preloaded MSB plane")

    def _all_precisions(self):
        yield from self.tiers.values()
        for by_layer in self.rules.values():
            yield from by_layer.values()

    @property
    def tier_names(self):
        return tuple(self.tiers)

    @property
    def w_signed(self) -> bool:
        return next(iter(self.tiers.values())).w_signed

    # ------------------------------------------------------------ kv tiers
    def kv_bits_for(self, tier: Optional[str] = None) -> Optional[int]:
        """KV storage precision of a tier (None = bf16): what a fixed-
        precision engine at that tier uses for its whole cache."""
        tier = self._tier(tier)
        if self.kv_tiers is None:
            return None
        return self.kv_tiers.get(tier)

    def kv_code_for(self, tier: Optional[str] = None) -> int:
        """A tier's code in the mixed arena (16 = bf16, 8, 4)."""
        kb = self.kv_bits_for(tier)
        return 16 if kb is None else kb

    @property
    def kv_modes(self) -> Optional[tuple]:
        """The codes the mixed arena serves, descending; None without
        ``kv_tiers``."""
        if self.kv_tiers is None:
            return None
        return tuple(sorted({self.kv_code_for(t) for t in self.tiers},
                            reverse=True))

    def tier_bits(self, tier: Optional[str] = None) -> tuple:
        """A tier's default ``(w_bits, a_bits)``, as admission prices it
        (``hwmodel.energy.relative_tier_costs``; per-layer rules are not
        seen)."""
        prec = self.tiers[self._tier(tier)]
        return (prec.w_bits, prec.a_bits)

    def _tier(self, tier: Optional[str]) -> str:
        tier = self.default_tier if tier is None else tier
        if tier not in self.tiers:
            raise KeyError(f"unknown tier {tier!r}; have {sorted(self.tiers)}")
        return tier

    def lookup(self, name: str, tier: Optional[str] = None) -> LayerPrecision:
        tier = self._tier(tier)
        for pattern, prec in self.rules.get(tier, {}).items():
            if fnmatch.fnmatch(name, pattern):
                return prec
        return self.tiers[tier]

    def policy_for(self, tier: Optional[str] = None) -> PrecisionPolicy:
        """One tier as a plain PrecisionPolicy (what a fixed-precision
        engine at that tier uses)."""
        tier = self._tier(tier)
        return PrecisionPolicy(rules=dict(self.rules.get(tier, {})),
                               default=self.tiers[tier])

    def prepare_policy(self) -> PrecisionPolicy:
        """The 8-bit policy the superplane store is prepared under."""
        default = next(iter(self.tiers.values()))
        return PrecisionPolicy(default=dataclasses.replace(
            default, w_bits=8, a_bits=8))


def uniform_schedule(tiers: Dict[str, tuple],
                     backend: str = "decomposed",
                     a_signed: bool = True,
                     kv_tiers: Optional[Dict[str, Optional[int]]] = None
                     ) -> PrecisionSchedule:
    """Schedule from ``{name: (w_bits, a_bits)}`` pairs, uniform per tier."""
    return PrecisionSchedule(tiers={
        name: LayerPrecision(w_bits=w, a_bits=a, backend=backend,
                             a_signed=a_signed)
        for name, (w, a) in tiers.items()}, kv_tiers=kv_tiers)
