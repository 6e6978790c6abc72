"""The program's own spans in a ``--trace 1`` run: the engine's and the
model's blocks as the port's recorder takes them
(``repro_torch.telemetry.trace``), moved onto the benchmark's axis (us on
the host's ``perf_counter``, the axis ``trace.DeviceTrace`` anchors the
card's operations to), and what the per-layer readers take from them: a
span's children, its self time, and the card's idle gaps labelled by the
innermost program span.

A program without the recorder slot records nothing: the stretch then has
no program spans, and every reader of them finds nothing to read.
"""
from __future__ import annotations

import bisect
import collections
from typing import Any, Dict, List, Optional, Tuple

from benchlib import trace

# The spans whose subtrees hold the model's blocks.
UNITS = ("decode_step", "prefill")


def start(rec: Optional[Any] = None) -> Optional[Any]:
    """``rec`` (default a new recorder) in the program's slot, or None
    where the program has no slot."""
    from repro_torch.telemetry import trace as program_trace
    if not hasattr(program_trace, "CURRENT"):
        return None
    if rec is None:
        rec = program_trace.Tracer()
    program_trace.CURRENT = rec
    return rec


def stop(rec: Optional[Any]) -> None:
    """Empties the program's slot."""
    if rec is not None:
        from repro_torch.telemetry import trace as program_trace
        program_trace.CURRENT = None


def spans_of(rec: Optional[Any]) -> List[trace.Span]:
    """The recorder's closed spans as the benchmark's, in us; ``info``
    holds their fields and ``id``, ``parent`` and ``uid``."""
    if rec is None:
        return []
    return [trace.Span(s.name, s.start * 1e6, s.end * 1e6,
                       dict(s.args, id=s.id, parent=s.parent, uid=s.uid))
            for s in rec.spans]


def program_spans(ctx: Any) -> List[trace.Span]:
    """A reader's program spans (none in an untraced run)."""
    if ctx.traced is None:
        return []
    return ctx.traced.get("program_spans") or []


def children(spans: List[trace.Span]) -> Dict[int, List[trace.Span]]:
    """Each span's id -> its child spans (0 -> the top-level spans)."""
    out: Dict[int, List[trace.Span]] = collections.defaultdict(list)
    for s in spans:
        out[s.info["parent"]].append(s)
    return out


def self_us(span: trace.Span, kids: List[trace.Span]) -> float:
    """The span's duration less the part of it its children cover."""
    return (span.end - span.start) - trace.busy_us(
        [(max(c.start, span.start), min(c.end, span.end)) for c in kids])


def host_less_sync_us(spans: List[trace.Span], name: str
                      ) -> Tuple[float, int]:
    """Sum over the spans called ``name`` of their duration less their
    ``sync`` children (the wait for the device's results), and their
    count."""
    kids = children(spans)
    total, n = 0.0, 0
    for s in spans:
        if s.label == name:
            total += (s.end - s.start) - sum(
                c.end - c.start for c in kids[s.info["id"]]
                if c.label == "sync")
            n += 1
    return total, n


def decode_host_ms(ctx: Any) -> Optional[float]:
    """The host's time to enqueue one decode step: the traced decode
    chunks less their closing copy, over the traced decode steps."""
    spans = program_spans(ctx)
    steps = sum(1 for s in spans if s.label == "decode_step")
    if not steps:
        return None
    host, _ = host_less_sync_us(spans, "decode_chunk")
    return host / steps / 1e3


def idle_gaps(dt: Any) -> List[Tuple[float, float]]:
    """The card's idle intervals in the traced stretch (no operation on
    it), in us."""
    gaps: List[Tuple[float, float]] = []
    end = dt.t_start
    for op in sorted(dt.ops, key=lambda o: o.start):
        if op.start > end:
            gaps.append((end, op.start))
        end = max(end, op.end)
    if dt.t_stop > end:
        gaps.append((end, dt.t_stop))
    return gaps


class Innermost:
    """The name of the innermost program span at a time, ``trace.Labeller``'s
    "host in <name>": one Labeller over each decode step's or prefill's
    subtree and one over the engine's spans between them (one Labeller
    over a stretch's ten thousand spans would take minutes)."""

    def __init__(self, spans: List[trace.Span]) -> None:
        kids = children(spans)
        units = sorted((s for s in spans if s.label in UNITS),
                       key=lambda s: s.start)
        inside = set()
        self.units: List[Tuple[trace.Span, trace.Labeller]] = []
        for u in units:
            tree, todo = [u], [u]
            while todo:
                below = kids[todo.pop().info["id"]]
                tree += below
                todo += below
            inside.update(id(s) for s in tree)
            self.units.append((u, trace.Labeller(tree)))
        self.starts = [u.start for u in units]
        self.engine = trace.Labeller([s for s in spans
                                      if id(s) not in inside])

    def _unit(self, t: float
              ) -> Optional[Tuple[trace.Span, trace.Labeller]]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.units[i][0].end:
            return self.units[i]
        return None

    def __call__(self, t: float) -> str:
        unit = self._unit(t)
        return (self.engine if unit is None else unit[1])(t)

    def in_block(self, t: float) -> bool:
        """Whether the innermost span at ``t`` is a model block: a span
        under a decode step or a prefill, other than its ``sync``."""
        unit = self._unit(t)
        return unit is not None and unit[1](t) not in (
            f"host in {unit[0].label}", "host in sync")


def idle_in_blocks_us(dt: Any, spans: List[trace.Span]
                      ) -> Tuple[float, float]:
    """The card's idle us in the traced stretch in gaps that began in a
    model block (:meth:`Innermost.in_block`), and in all gaps."""
    inner = Innermost(spans)
    blocks = total = 0.0
    for a, b in idle_gaps(dt):
        total += b - a
        if inner.in_block(a):
            blocks += b - a
    return blocks, total


def idle_by_label(dt: Any, spans: List[trace.Span]) -> Dict[str, float]:
    """The card's idle us in the traced stretch, summed by the innermost
    program span in which each gap began."""
    label = Innermost(spans)
    out: Dict[str, float] = {}
    for a, b in idle_gaps(dt):
        lab = label(a)
        out[lab] = out.get(lab, 0.0) + (b - a)
    return out


def block_table(dt: Optional[Any], spans: List[trace.Span]
                ) -> Dict[str, Any]:
    """Per block kind: host ms per decode step and per prefill (whole spans
    and self time) and, given the card's trace ``dt``, its idle seconds in
    gaps that began in it; a block that counts its kernel launches
    (``linear``, ``attn_core``) also its launches per decode step."""
    kids = children(spans)
    by_id = {s.info["id"]: s for s in spans}

    def unit_of(s: trace.Span) -> Optional[str]:
        while s.info["parent"]:
            s = by_id.get(s.info["parent"])
            if s is None:
                return None
            if s.label in UNITS:
                return s.label
        return None

    n = {u: sum(1 for s in spans if s.label == u) for u in UNITS}
    rows: Dict[str, Dict[str, float]] = {}
    for s in spans:
        u = unit_of(s) if s.label != "emit" else "decode_step"
        if u is None or not n[u]:
            continue
        row = rows.setdefault(s.label, {})
        row[f"{u}_ms"] = row.get(f"{u}_ms", 0.0) + \
            (s.end - s.start) / 1e3 / n[u]
        row[f"{u}_self_ms"] = row.get(f"{u}_self_ms", 0.0) + \
            self_us(s, kids[s.info["id"]]) / 1e3 / n[u]
        if "launches" in s.info and u == "decode_step":
            row["launches_per_step"] = row.get("launches_per_step", 0.0) \
                + s.info["launches"] / n[u]
    out = {"decode_steps": n["decode_step"], "prefills": n["prefill"],
           "blocks": rows}
    if dt is not None:
        idle = idle_by_label(dt, spans)
        for lab, us in idle.items():
            name = lab[8:] if lab.startswith("host in ") else lab
            rows.setdefault(name, {})["idle_s"] = us / 1e6
        out["idle_s"] = sum(idle.values()) / 1e6
    return out
