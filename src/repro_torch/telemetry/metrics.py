"""Typed metric primitives + the serving metric registry.

Three metric kinds, all host-side and allocation-light:

* :class:`Counter` — monotone totals (``inc``), with a ``set`` escape
  hatch used ONLY by the :class:`~repro_torch.serve.engine.EngineStats`
  twin sync (the engine's dataclass counters stay the source of truth; the
  registry mirrors them so exporters and the report function never
  hand-list fields).
* :class:`Gauge` — last-write-wins instantaneous values (queue depth,
  utilization ratios).
* :class:`Histogram` — FIXED bucket upper bounds: ``observe`` does one
  bisect + three adds, so p50/p99 come out of the bucket counts without
  ever storing samples (the zero-allocation-per-observation contract of
  the telemetry layer).

Every metric may declare label names; series are keyed by the label-value
tuple.  :func:`sync_engine_stats` derives the twin counters automatically
from ``dataclasses.fields`` — a new ``EngineStats`` field becomes a new
``serve_<field>`` series with no telemetry change (and the fuzz harness
asserts the twins stay equal after every engine op).

Derived serving metrics (the paper's utilization story):

* slot utilization — ``decode_slot_steps / (decode_steps * num_slots)``;
* modeled-cycle utilization — useful MACs priced by
  :func:`repro_torch.hwmodel.energy.tier_cycles_per_token` against the cycles
  the dispatched decode lanes occupied (see
  :meth:`repro_torch.telemetry.Telemetry.on_decode_chunk`);
* speculative acceptance rate — ``spec_accepted / spec_drafted``.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, \
    Tuple, Union

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "TICK_BUCKETS", "SECONDS_BUCKETS", "format_group_layout",
           "sync_engine_stats", "slot_utilization", "spec_acceptance_rate"]

LabelKey = Tuple[str, ...]

# Scheduler-clock histograms: powers of two up to 1024 ticks cover every
# serving trace the benchmarks run (one tick = one decode step).
TICK_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(11))
# Wall-clock histograms: ~log-spaced 100us .. 30s.
SECONDS_BUCKETS: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


def _label_key(declared: LabelKey, labels: Mapping[str, str]) -> LabelKey:
    if set(labels) != set(declared):
        raise ValueError(f"expected labels {declared}, got "
                         f"{tuple(sorted(labels))}")
    return tuple(str(labels[name]) for name in declared)


class _Series:
    """Shared label-series bookkeeping of Counter and Gauge."""

    kind = "untyped"

    def __init__(self, name: str, help: str, *, unit: str = "",
                 labels: LabelKey = ()) -> None:
        self.name = name
        self.help = help
        self.unit = unit
        self.labels = tuple(labels)
        self._values: Dict[LabelKey, float] = {}

    def get(self, **labels: str) -> float:
        return self._values.get(_label_key(self.labels, labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        """Label-value tuple -> current value (unlabeled: key ``()``)."""
        return dict(self._values)

    def _set(self, value: float, labels: Mapping[str, str]) -> None:
        self._values[_label_key(self.labels, labels)] = value


class Counter(_Series):
    """Monotone counter (optionally labeled)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = _label_key(self.labels, labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def set(self, value: float, **labels: str) -> None:
        """Twin sync only: mirror an externally-owned monotone total."""
        self._set(value, labels)


class Gauge(_Series):
    """Instantaneous value (optionally labeled)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        self._set(value, labels)


class Histogram:
    """Fixed-bucket histogram: quantiles without stored samples.

    ``buckets`` are finite upper bounds (ascending); an implicit +Inf
    bucket catches the overflow.  ``quantile`` linearly interpolates
    inside the winning bucket (the +Inf bucket degenerates to the last
    finite bound), which is exactly the Prometheus ``histogram_quantile``
    estimator."""

    kind = "histogram"

    def __init__(self, name: str, help: str, *, unit: str = "",
                 buckets: Sequence[float] = TICK_BUCKETS) -> None:
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"strictly ascending non-empty sequence, got "
                             f"{list(buckets)}")
        if any(math.isinf(b) for b in buckets):
            raise ValueError(f"histogram {name}: +Inf bucket is implicit")
        self.name = name
        self.help = help
        self.unit = unit
        self.labels: LabelKey = ()
        self.uppers: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.uppers, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0.0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= target:
                if i >= len(self.uppers):      # overflow bucket
                    return self.uppers[-1]
                lo = self.uppers[i - 1] if i else 0.0
                frac = (target - cum) / n
                return lo + frac * (self.uppers[i] - lo)
            cum += n
        return self.uppers[-1]

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name-keyed, insertion-ordered registry of typed metrics.

    Registration is idempotent per (name, kind): ``counter(name, ...)``
    returns the existing series on re-registration, so the engine sync
    and the exporters can both "declare" metrics without coordination.
    A kind clash (the same name registered as two kinds) raises."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _register(self, metric: Metric) -> Metric:
        have = self._metrics.get(metric.name)
        if have is not None:
            if have.kind != metric.kind:
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{have.kind}, re-registered as {metric.kind}")
            return have
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "", *, unit: str = "",
                labels: LabelKey = ()) -> Counter:
        got = self._register(Counter(name, help, unit=unit, labels=labels))
        assert isinstance(got, Counter)
        return got

    def gauge(self, name: str, help: str = "", *, unit: str = "",
              labels: LabelKey = ()) -> Gauge:
        got = self._register(Gauge(name, help, unit=unit, labels=labels))
        assert isinstance(got, Gauge)
        return got

    def histogram(self, name: str, help: str = "", *, unit: str = "",
                  buckets: Sequence[float] = TICK_BUCKETS) -> Histogram:
        got = self._register(Histogram(name, help, unit=unit,
                                       buckets=buckets))
        assert isinstance(got, Histogram)
        return got

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Current value of a counter/gauge series (0.0 when absent)."""
        metric = self._metrics.get(name)
        if metric is None:
            return 0.0
        if isinstance(metric, Histogram):
            raise TypeError(f"{name} is a histogram; use get(name).quantile")
        return metric.get(**labels)

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: every series of every metric, plus histogram
        bucket counts and the p50/p99 estimates."""
        out: Dict[str, Any] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[m.name] = {
                    "kind": m.kind, "unit": m.unit, "help": m.help,
                    "buckets": list(m.uppers), "counts": list(m.counts),
                    "sum": m.sum, "count": m.count,
                    "p50": m.quantile(0.5), "p99": m.quantile(0.99),
                }
            else:
                out[m.name] = {
                    "kind": m.kind, "unit": m.unit, "help": m.help,
                    "labels": list(m.labels),
                    "series": {",".join(k) if k else "": v
                               for k, v in m.series().items()},
                }
        return out


# ------------------------------------------------------- EngineStats twins
# EngineStats dict fields keyed by tier name -> labeled counter.
_TIER_DICT_FIELDS = ("decode_steps_by_tier", "tokens_by_tier")


def format_group_layout(layout: Tuple[Tuple[str, int], ...]) -> str:
    """Stable label text of a mixed-tier group layout:
    ``(("8/8", 2), ("4/4", 1))`` -> ``"8/8x2+4/4x1"``."""
    return "+".join(f"{tier}x{rows}" for tier, rows in layout)


def sync_engine_stats(registry: MetricsRegistry, stats: Any,
                      prefix: str = "serve_") -> None:
    """Mirror an ``EngineStats`` into the registry (the twin sync).

    Field discovery is ``dataclasses.fields`` — every int field becomes
    the counter ``<prefix><field>``, the per-tier dicts become
    tier-labeled counters, and ``decode_dispatches`` (GroupLayout ->
    kernel launches of one decode step) becomes a layout-labeled gauge.
    ``stats`` is duck-typed (any counters dataclass) so the telemetry
    package never imports the engine."""
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, int):
            registry.counter(prefix + f.name,
                             f"EngineStats.{f.name} twin").set(float(v))
        elif f.name in _TIER_DICT_FIELDS:
            c = registry.counter(prefix + f.name,
                                 f"EngineStats.{f.name} twin",
                                 labels=("tier",))
            for tier_name, n in v.items():
                c.set(float(n), tier=str(tier_name))
        elif f.name == "decode_dispatches":
            g = registry.gauge(prefix + "decode_dispatches",
                               "kernel launches of one decode step, per "
                               "group layout",
                               labels=("layout",))
            for layout, n in v.items():
                g.set(float(n), layout=format_group_layout(layout))


# -------------------------------------------------------- derived metrics
def slot_utilization(stats: Any, num_slots: int) -> float:
    """``decode_slot_steps / (decode_steps * num_slots)`` — the fraction
    of dispatched decode lanes that produced a token (1.0 = every lane of
    every step was an active request)."""
    total = stats.decode_steps * num_slots
    return stats.decode_slot_steps / total if total else 0.0


def spec_acceptance_rate(stats: Any) -> float:
    """``spec_accepted / spec_drafted`` (0.0 before any speculative round)."""
    return (stats.spec_accepted / stats.spec_drafted
            if stats.spec_drafted else 0.0)
