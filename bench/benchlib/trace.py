"""The traced part of a ``--trace 1`` run: the device's operations from
``torch.profiler`` (CUDA activity only, so the host is barely slowed),
host intervals labelled by the benchmark's own wrappers of the public
entry points, and what the per-layer readers take from them.

Host and device clocks are tied by an anchor: a fill launched right after
a synchronize, at a known host time.  Every engine phase (a
prefill, a decode chunk) ends in a copy to the host, so a device operation
belongs to the phase whose host interval it starts in.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

# plane_gemm_kernel<BM, BK, kPacked, kGrouped>, demangled or mangled.
_CORE = re.compile(r"plane_gemm_kernel<\s*(\d+)\s*,\s*(\d+)\s*,\s*"
                   r"([^,>]+?)\s*,\s*([^,>]+?)\s*>")
_TRUE = ("true", "1", "(bool)1")
_CORE_MANGLED = re.compile(r"plane_gemm_kernelILi(\d+)ELi(\d+)ELb([01])ELb"
                           r"([01])E")
ANCHOR_CYCLES = 20000
ANCHOR_ELEMS = 4099


def kernel_name(name: str, width: int = 110) -> str:
    """A device operation's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i][:width]
    return name[:width]


def busy_us(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of intervals (start, end)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def core_kind(name: str) -> Optional[Tuple[bool, bool]]:
    """(packed, grouped) of a plane-GEMM core kernel, else None."""
    m = _CORE.search(name)
    if m is not None:
        return m.group(3) in _TRUE, m.group(4) in _TRUE
    m = _CORE_MANGLED.search(name)
    if m is not None:
        return m.group(3) == "1", m.group(4) == "1"
    return None


@dataclasses.dataclass
class Op:
    name: str
    start: float      # us on the host's perf_counter clock
    end: float


@dataclasses.dataclass
class Span:
    label: str
    start: float      # us, perf_counter
    end: float
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Recorder:
    """Host intervals of the wrapped entry points, on perf_counter (us).
    Installed only in a traced run: an untraced run wraps nothing."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.on = False
        self._undo: List[Tuple[Any, str]] = []

    def wrap(self, obj: Any, attr: str, label: str, info=None) -> None:
        inner = getattr(obj, attr)
        rec = self

        def wrapped(*args, **kwargs):
            if not rec.on:
                return inner(*args, **kwargs)
            t0 = time.perf_counter() * 1e6
            try:
                return inner(*args, **kwargs)
            finally:
                rec.spans.append(Span(label, t0, time.perf_counter() * 1e6,
                                      info(args, kwargs) if info else {}))
        setattr(obj, attr, wrapped)
        self._undo.append((obj, attr))

    def unwrap(self) -> None:
        for obj, attr in reversed(self._undo):
            try:
                delattr(obj, attr)
            except AttributeError:
                pass
        self._undo.clear()


class DeviceTrace:
    """One profiled stretch of the window."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.prof: Any = None
        self.ops: List[Op] = []
        self.t_start = 0.0
        self.t_stop = 0.0

    @staticmethod
    def warm(device: torch.device) -> None:
        """Starts and stops the profiler once (its first start loads and
        initialises CUPTI, which takes seconds): part of set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(ANCHOR_CYCLES)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter() * 1e6
        self._anchor = torch.empty((ANCHOR_ELEMS,), device=self.device)
        self._anchor.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter() * 1e6
        self.prof.__exit__(None, None, None)

    def collect(self) -> None:
        """Reads the device operations (after the window: this is slow)."""
        from torch.autograd import DeviceType
        raw = [(e.name, e.time_range.start, e.time_range.end)
               for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        self.prof = None
        if not raw:
            raise RuntimeError("trace: the profiler recorded no device "
                               "operation")
        # The anchor is the first fill on the device after the profiler
        # started: nothing else was in flight, and the next engine step
        # launches only after the host read the time.
        raw.sort(key=lambda r: r[1])
        fills = [r for r in raw[:8] if "fill" in r[0].lower()]
        anchor = fills[0] if fills else raw[0]
        if not fills:
            print("trace: no fill among the first device operations "
                  f"{[r[0][:40] for r in raw[:4]]}; aligned on the first",
                  file=sys.stderr)
        offset = self.t_start - anchor[1]
        self.ops = [Op(kernel_name(n), s + offset, e + offset)
                    for n, s, e in raw if (n, s, e) != anchor]

    @property
    def window_us(self) -> float:
        return self.t_stop - self.t_start


def phases(spans: List[Span], t0: float, t1: float
           ) -> List[Tuple[float, float, str]]:
    """The engine phases in [t0, t1): each prefill from its wrapper's start,
    each decode chunk from its first decode step's start, ending where the
    next phase or engine step begins; the rest is host work outside."""
    marks: List[Tuple[float, str]] = []
    last = None
    for s in sorted(spans, key=lambda s: s.start):
        if s.label == "prefill":
            marks.append((s.start, "prefill"))
        elif s.label == "decode_step" and last != "decode_step":
            marks.append((s.start, "decode"))
        elif s.label == "step":
            marks.append((s.start, "host"))
        last = s.label
    out = []
    for i, (t, lab) in enumerate(marks):
        end = marks[i + 1][0] if i + 1 < len(marks) else t1
        a, b = max(t, t0), min(end, t1)
        if b > a:
            out.append((a, b, lab))
    return out


class Labeller:
    """What the host was doing at a time: the innermost wrapped call, read
    from the spans cut into elementary segments once."""

    OUTSIDE = "driver (outside engine.step)"

    def __init__(self, spans: List[Span]) -> None:
        self.points = sorted({p for s in spans for p in (s.start, s.end)})
        self.labels: List[str] = []
        for a in self.points:
            best: Optional[Span] = None
            for s in spans:
                if s.start <= a < s.end and (best is None
                                             or s.start >= best.start):
                    best = s
            self.labels.append(self.OUTSIDE if best is None
                               else f"host in {best.label}")

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.points, t) - 1
        return self.OUTSIDE if i < 0 else self.labels[i]


def breakdown(trace: DeviceTrace, spans: List[Span]) -> Dict[str, Any]:
    """The device operations that took most time, and the idle time summed
    by what the host was doing when each gap began."""
    by_name: Dict[str, float] = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps: List[Tuple[float, float]] = []
    end = trace.t_start
    for op in sorted(trace.ops, key=lambda o: o.start):
        if op.start > end:
            gaps.append((end, op.start))
        end = max(end, op.end)
    if trace.t_stop > end:
        gaps.append((end, trace.t_stop))
    label = Labeller(spans)
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        lab = label(a)
        by_label[lab] = by_label.get(lab, 0.0) + (b - a)
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}
