"""Opt-in device timing (``Telemetry(profile=True)``; port of
``repro.telemetry.profile``).

CUDA work is asynchronous: the wall time around an engine dispatch can end
before the device does.  The profiler FENCES each phase on the engine's
device before its end timestamp: a CUDA event recorded on the device's
current stream and waited on (``Event.synchronize``), so the phase's wall
seconds cover the device work.  The event recorded at the phase's start
(:meth:`DeviceProfiler.start`) gives, with the fence's event, the device
seconds from the phase's first enqueued work to its last
(``Event.elapsed_time``): a span of the stream's timeline, idle gaps
included, not a sum of kernel times.  Fencing is a real host sync, which
is why it is opt-in: with the profiler off (or telemetry off) the engine
makes no ``torch.cuda.synchronize``, ``Event.synchronize`` or
``Event.elapsed_time`` call, and fencing never changes computed bits.  On
the CPU every dispatch finishes before it returns; the fence does nothing
and no device seconds are recorded.

Phases mirror the engine's dispatch sites: ``prefill``, ``decode_chunk``,
``spec_round``, ``migrate_kv``.  The profiler also carries the per-layout
kernel launches of one decode step (``ServeEngine.decode_dispatch_count``;
a profiling engine counts every layout it dispatches, as
``count_dispatches=True`` does).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["DeviceProfiler"]


class DeviceProfiler:
    """Per-phase device timing accumulator (see module docstring)."""

    def __init__(self) -> None:
        self.phase_seconds: Dict[str, float] = {}
        self.phase_calls: Dict[str, int] = {}
        # Phase -> device seconds between its start and fence events (CUDA
        # only).
        self.device_seconds: Dict[str, float] = {}
        # Group-layout label -> kernel launches of one decode step.
        self.dispatch_counts: Dict[str, int] = {}
        self._start: Optional[torch.cuda.Event] = None

    def start(self, device: Any) -> None:
        """Record the start event of a phase on ``device`` (CUDA only)."""
        self._start = None
        if torch.device(device).type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(device))

    def fence(self, device: Any, phase: str) -> None:
        """Wait until the work enqueued on ``device`` so far is done, and
        add the phase's device seconds since :meth:`start`."""
        if torch.device(device).type != "cuda":
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        if self._start is not None:
            self.device_seconds[phase] = self.device_seconds.get(
                phase, 0.0) + self._start.elapsed_time(end) / 1e3
            self._start = None

    def record(self, phase: str, seconds: float) -> None:
        self.phase_seconds[phase] = \
            self.phase_seconds.get(phase, 0.0) + seconds
        self.phase_calls[phase] = self.phase_calls.get(phase, 0) + 1

    def record_dispatch_count(self, layout_label: str, count: int) -> None:
        self.dispatch_counts[layout_label] = count

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able per-phase totals, call counts and mean seconds (and
        device seconds where measured)."""
        phases: Dict[str, Any] = {}
        for phase, total in sorted(self.phase_seconds.items()):
            calls = self.phase_calls.get(phase, 0)
            phases[phase] = {"calls": calls, "total_s": total,
                             "mean_s": total / max(calls, 1)}
            if phase in self.device_seconds:
                phases[phase]["device_s"] = self.device_seconds[phase]
        return {"phases": phases,
                "decode_dispatches": dict(self.dispatch_counts)}
