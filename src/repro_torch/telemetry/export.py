"""Exporters: Prometheus text exposition, JSON snapshot, and the serving
report (the summary ``launch/serve.py`` ends its run with).

The Prometheus renderer follows the text exposition format (``# HELP`` /
``# TYPE`` headers, ``name{label="v"} value`` samples; histograms as
cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``) closely
enough that :func:`parse_prometheus` — a minimal parser of the same
format — round-trips every sample bit-exactly, which
``tests/test_torch_telemetry.py`` asserts.  Metric names keep their
registry names verbatim (no ``_total`` suffix rewriting) so the round-trip
and the ``EngineStats`` twin assertions need no name mapping.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.telemetry.metrics import Histogram, MetricsRegistry

__all__ = ["to_prometheus", "parse_prometheus", "to_json", "write_json",
           "serve_report"]

# One parsed sample set: metric name -> {sorted (label, value) tuple: value}.
ParsedSamples = Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]'
                       r'|\\.)*)"')


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _unescape(value: str) -> str:
    return value.replace("\\n", "\n").replace('\\"', '"') \
        .replace("\\\\", "\\")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    lines = []
    for m in registry:
        if not _NAME_RE.fullmatch(m.name):
            raise ValueError(f"invalid metric name {m.name!r}")
        if m.help:
            # HELP payloads escape only backslash and newline (the
            # exposition-format rule; quotes stay raw outside labels).
            help_text = m.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {m.name} {help_text}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            cum = 0
            for upper, n in zip(m.uppers, m.counts):
                cum += n
                lines.append(f'{m.name}_bucket{{le="{_fmt_value(upper)}"}}'
                             f" {float(cum)!r}")
            lines.append(f'{m.name}_bucket{{le="+Inf"}} {float(m.count)!r}')
            lines.append(f"{m.name}_sum {m.sum!r}")
            lines.append(f"{m.name}_count {float(m.count)!r}")
        else:
            series = m.series()
            if not series and not m.labels:
                series = {(): 0.0}
            for key, value in sorted(series.items()):
                lines.append(f"{m.name}{_fmt_labels(m.labels, key)} "
                             f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> ParsedSamples:
    """Minimal text-exposition parser (the round-trip test's other half).

    Returns ``{metric name: {((label, value), ...) sorted: sample}}``;
    ``# HELP``/``# TYPE`` comment lines are skipped, histogram series
    appear under their ``_bucket``/``_sum``/``_count`` sample names."""
    out: ParsedSamples = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {raw!r}")
        labels: Tuple[Tuple[str, str], ...] = ()
        if m.group("labels"):
            labels = tuple(sorted(
                (lm.group("k"), _unescape(lm.group("v")))
                for lm in _LABEL_RE.finditer(m.group("labels"))))
        out.setdefault(m.group("name"), {})[labels] = \
            float(m.group("value"))
    return out


def to_json(registry: MetricsRegistry,
            profile: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """JSON snapshot: the registry dump plus (optionally) the device
    profiler's per-phase timings."""
    out: Dict[str, Any] = {"metrics": registry.snapshot()}
    if profile is not None:
        out["profile"] = profile
    return out


def write_json(path: str, registry: MetricsRegistry,
               profile: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as fh:
        json.dump(to_json(registry, profile), fh, indent=2, sort_keys=True)
        fh.write("\n")


# ------------------------------------------------------------ serve report
def _hist_line(registry: MetricsRegistry, name: str, unit: str) -> str:
    h = registry.get(name)
    if not isinstance(h, Histogram) or h.count == 0:
        return "n/a"
    return (f"p50={h.quantile(0.5):.3g} p99={h.quantile(0.99):.3g} {unit} "
            f"(n={h.count})")


def serve_report(registry: MetricsRegistry, *,
                 tiers: Optional[Sequence[str]] = None,
                 mixed: bool = True, slo: bool = False,
                 speculate: bool = False, overload: bool = False) -> str:
    """The consolidated serving report ``launch/serve.py`` prints.

    Every number is read back out of the registry — the EngineStats twin
    counters, the derived utilization gauges and the latency histograms —
    so a new stat surfaces here by being registered, not by editing
    per-section format strings.  Sections beyond the summary appear only
    when their feature was on (same conditions the prints had)."""
    v = registry.value
    lines = [
        "stats: "
        f"prefills={v('serve_prefills'):.0f} "
        f"decode_steps={v('serve_decode_steps'):.0f} "
        f"slot_steps={v('serve_decode_slot_steps'):.0f} "
        f"chunks={v('serve_decode_chunks'):.0f} "
        f"slot_util={v('serve_slot_utilization'):.2f} "
        f"modeled_cycle_util={v('serve_modeled_cycle_utilization'):.2f}",
        "latency: "
        f"ttft {_hist_line(registry, 'serve_ttft_ticks', 'ticks')}; "
        f"tpot {_hist_line(registry, 'serve_tpot_ticks', 'ticks/tok')}; "
        f"queue_wait {_hist_line(registry, 'serve_queue_wait_ticks', 'ticks')}"
    ]
    if tiers:
        per = " ".join(
            f"{t}:{v('serve_decode_steps_by_tier', tier=t):.0f}"
            for t in tiers)
        mode = "mixed" if mixed else "serialized"
        lines.append(
            f"tier decode_steps ({mode}): {per} "
            f"(switches={v('serve_tier_switches'):.0f} "
            f"mixed_chunks={v('serve_mixed_tier_chunks'):.0f} "
            f"migrations={v('serve_tier_migrations'):.0f} "
            f"kv_migrations={v('serve_kv_migrations'):.0f})")
    if slo:
        lines.append(
            "slo: queue_wait "
            f"{_hist_line(registry, 'serve_queue_wait_ticks', 'ticks')}, "
            f"deadline_misses={v('serve_deadline_misses'):.0f}, "
            f"tier_autoselects={v('serve_tier_autoselects'):.0f}")
    if speculate:
        drafted = v("serve_spec_drafted")
        emitted = v("serve_spec_emitted")
        vpt = v("serve_spec_verify_steps") / emitted if emitted \
            else float("nan")
        lines.append(
            f"speculate: rounds={v('serve_spec_rounds'):.0f} "
            f"accepted={v('serve_spec_accepted'):.0f}/{drafted:.0f} "
            f"({v('serve_spec_acceptance_rate'):.0%}) "
            f"emitted={emitted:.0f} verify_steps/token={vpt:.2f}")
    if overload:
        lines.append(
            f"overload: preemptions={v('serve_preemptions'):.0f} "
            f"resumes={v('serve_resumes'):.0f} "
            f"sheds={v('serve_sheds'):.0f} "
            f"spill_bytes={v('serve_spill_bytes'):.0f} "
            f"time_slice_preemptions="
            f"{v('serve_time_slice_preemptions'):.0f}")
    return "\n".join(lines)
