"""Spans, metrics and trace export for the serving stack (port of
``repro.telemetry``).

The package is a sensor layer over the engines of
:mod:`repro_torch.serve.engine` with two contracts, both enforced by
``tests/test_torch_telemetry.py``:

* **zero-cost-when-off** — a ``telemetry=None`` engine (the default) runs
  the decode hot loop with ZERO additional host syncs or hook calls (the
  module-level :data:`HOOK_CALLS` spy counts every hook entry, and the
  engine itself never synchronizes with the device — only the opt-in
  :class:`~repro_torch.telemetry.profile.DeviceProfiler` does);
* **bitwise stability when on** — every hook observes after the fact;
  enabling telemetry (even with device profiling) leaves every stream
  token-identical, on a tensor-parallel mesh too
  (``tests/test_torch_tp.py``), where rank 0's engine records for the
  mesh and the other ranks' hold no telemetry.

Composition (one object, four concerns):

* :class:`~repro_torch.telemetry.metrics.MetricsRegistry` — typed
  counters / gauges / fixed-bucket histograms, auto-twinned with
  ``EngineStats``;
* :class:`~repro_torch.telemetry.trace.Tracer` — dual-clock spans
  exported as Chrome trace-event JSON (Perfetto-loadable);
* :class:`~repro_torch.telemetry.profile.DeviceProfiler` — opt-in
  (``Telemetry(profile=True)``) fenced device timing per dispatch phase;
* exporters in :mod:`repro_torch.telemetry.export` — Prometheus text, JSON
  snapshot, and the consolidated serving report.

The modeled-cycle utilization gauge is the paper's utilization claim made
observable: every dispatched decode lane is priced in absolute array
cycles per token at its tier
(:func:`repro_torch.hwmodel.energy.tier_cycles_per_token`), and the gauge
is the ratio of cycles that served an active request to cycles the
dispatches occupied in total.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.telemetry.export import (parse_prometheus, serve_report,
                                          to_json, to_prometheus, write_json)
from repro_torch.telemetry.metrics import (SECONDS_BUCKETS, TICK_BUCKETS,
                                           Counter, Gauge, Histogram, Metric,
                                           MetricsRegistry,
                                           format_group_layout,
                                           slot_utilization,
                                           spec_acceptance_rate,
                                           sync_engine_stats)
from repro_torch.telemetry.profile import DeviceProfiler
from repro_torch.telemetry.trace import ENGINE_TRACK, PID, Tracer

__all__ = ["Telemetry", "HOOK_CALLS", "Counter", "Gauge", "Histogram",
           "Metric", "MetricsRegistry", "Tracer", "DeviceProfiler",
           "TICK_BUCKETS", "SECONDS_BUCKETS", "ENGINE_TRACK", "PID",
           "format_group_layout", "sync_engine_stats", "slot_utilization",
           "spec_acceptance_rate", "to_prometheus", "parse_prometheus",
           "to_json", "write_json", "serve_report"]

# Spy counter: EVERY Telemetry hook entry bumps it.  The zero-cost-when-off
# test drains a telemetry-None engine and asserts this never moved — the
# cheapest possible proof that the hot loop took no observability branches.
HOOK_CALLS = 0

# One telemetry lane: (tier name or None for an idle/masked lane,
# active steps the lane served within the dispatch).
Lane = Tuple[Optional[str], int]


def _bump() -> None:
    global HOOK_CALLS
    HOOK_CALLS += 1


@dataclasses.dataclass
class _RequestRecord:
    """Per-request latency bookkeeping (dual clock, host-side only)."""

    tier: Optional[str]
    deadline: Optional[float]
    submit_ticks: float
    submit_wall: float
    admitted: bool = False
    first_ticks: Optional[float] = None
    first_wall: Optional[float] = None
    last_ticks: float = 0.0
    last_wall: float = 0.0
    n_tokens: int = 0


class Telemetry:
    """The facade a :class:`~repro_torch.serve.engine.ServeEngine` accepts
    as ``telemetry=``.  Construct with ``profile=True`` to also fence and
    time device dispatches (a real host sync per dispatch — opt-in)."""

    def __init__(self, *, profile: bool = False) -> None:
        self.registry = MetricsRegistry()
        self.tracer = Tracer()
        self.profiler: Optional[DeviceProfiler] = \
            DeviceProfiler() if profile else None
        self._requests: Dict[int, _RequestRecord] = {}
        self._num_slots = 0
        self._default_tier: Optional[str] = None
        self._cycles_per_token: Dict[str, float] = {}
        self._useful_cycles = 0.0
        self._issued_cycles = 0.0
        r = self.registry
        self.queue_wait = r.histogram(
            "serve_queue_wait_ticks",
            "submit -> first admission, scheduler ticks", unit="ticks")
        self.ttft_ticks = r.histogram(
            "serve_ttft_ticks", "submit -> first token, scheduler ticks",
            unit="ticks")
        self.ttft_seconds = r.histogram(
            "serve_ttft_seconds", "submit -> first token, wall seconds",
            unit="s", buckets=SECONDS_BUCKETS)
        self.tpot_ticks = r.histogram(
            "serve_tpot_ticks", "mean ticks per output token after the "
            "first", unit="ticks")
        self.tpot_seconds = r.histogram(
            "serve_tpot_seconds", "mean wall seconds per output token "
            "after the first", unit="s", buckets=SECONDS_BUCKETS)
        self.deadline_misses = r.counter(
            "serve_deadline_misses",
            "requests that finished past submit + deadline (ticks)")
        r.gauge("serve_queue_depth", "requests waiting for a slot")
        r.gauge("serve_slot_utilization",
                "decode_slot_steps / (decode_steps * num_slots)")
        r.gauge("serve_modeled_cycle_utilization",
                "modeled array cycles serving active lanes / cycles "
                "dispatched (tier_cycles_per_token pricing)")
        r.gauge("serve_spec_acceptance_rate", "spec_accepted / spec_drafted")

    # ------------------------------------------------------------ plumbing
    def wall(self) -> float:
        """Wall seconds since the tracer epoch (the span clock)."""
        return self.tracer.now()

    def dispatch_start(self, device: Any) -> float:
        """The span clock at the start of an engine dispatch on ``device``;
        a profiling telemetry also records the phase's start event there
        (:meth:`DeviceProfiler.start`)."""
        if self.profiler is not None:
            self.profiler.start(device)
        return self.wall()

    def attach_engine(self, *, num_slots: int, schedule: Any = None,
                      mac_counts: Optional[Mapping[str, float]] = None
                      ) -> None:
        """Called by the engine at construction: slot count for the
        utilization denominator, and (when serving a PrecisionSchedule)
        the per-tier cycles/token price list for modeled-cycle
        utilization."""
        self._num_slots = num_slots
        if schedule is not None:
            from repro_torch.hwmodel.energy import tier_cycles_per_token
            self._cycles_per_token = dict(
                tier_cycles_per_token(schedule, mac_counts))
            self._default_tier = str(schedule.default_tier)

    def _cycles(self, tier: Optional[str]) -> float:
        name = tier if tier is not None else self._default_tier
        if name is None:
            return 1.0
        return self._cycles_per_token.get(name, 1.0)

    def _account(self, lanes: Sequence[Lane], n_steps: int) -> None:
        """Price one dispatch: every lane occupies ``n_steps`` modeled
        steps at its tier (idle lanes at the default tier — the array is
        dispatched either way), of which ``active`` served a request."""
        for tier, active in lanes:
            cyc = self._cycles(tier)
            self._issued_cycles += n_steps * cyc
            self._useful_cycles += active * cyc

    # ----------------------------------------------------- request lifecycle
    def on_submit(self, handle: Any, *, ticks: float) -> None:
        _bump()
        req = handle.request
        self._requests[int(req.uid)] = _RequestRecord(
            tier=req.tier, deadline=req.deadline,
            submit_ticks=ticks, submit_wall=self.wall())
        self.tracer.request_phase(int(req.uid), "queued", ticks=ticks)

    def on_shed(self, handle: Any, *, ticks: float) -> None:
        _bump()
        uid = int(handle.request.uid)
        self.tracer.request_end(uid, "shed", ticks=ticks)
        self.tracer.engine_instant("shed", ticks=ticks, args={"uid": uid})
        self._requests.pop(uid, None)

    def on_admit(self, handle: Any, *, slot: int, ticks: float,
                 resumed: bool = False) -> None:
        _bump()
        uid = int(handle.request.uid)
        self.tracer.request_phase(uid, "running", ticks=ticks)
        if resumed:
            self.tracer.engine_instant("resume", ticks=ticks,
                                       args={"uid": uid})
        rec = self._requests.get(uid)
        if rec is not None and not rec.admitted:
            rec.admitted = True
            if not resumed:
                self.queue_wait.observe(ticks - rec.submit_ticks)

    def on_suspend(self, handle: Any, *, ticks: float) -> None:
        _bump()
        uid = int(handle.request.uid)
        self.tracer.request_phase(uid, "suspended", ticks=ticks)
        self.tracer.engine_instant("preempt", ticks=ticks,
                                   args={"uid": uid})

    def on_token(self, event: Any, *, ticks: float) -> None:
        _bump()
        uid = int(event.uid)
        rec = self._requests.get(uid)
        if rec is None:
            return
        now = self.wall()
        if rec.first_ticks is None:
            rec.first_ticks = ticks
            rec.first_wall = now
            self.ttft_ticks.observe(ticks - rec.submit_ticks)
            self.ttft_seconds.observe(now - rec.submit_wall)
        rec.n_tokens += 1
        rec.last_ticks = ticks
        rec.last_wall = now
        if event.final:
            n = max(rec.n_tokens - 1, 1)
            assert rec.first_wall is not None
            self.tpot_ticks.observe((rec.last_ticks - rec.first_ticks) / n)
            self.tpot_seconds.observe((rec.last_wall - rec.first_wall) / n)
            if rec.deadline is not None \
                    and ticks - rec.submit_ticks > float(rec.deadline):
                self.deadline_misses.inc()
            self.tracer.request_end(uid, "finished", ticks=ticks)
            self._requests.pop(uid, None)

    # ------------------------------------------------------- dispatch spans
    def on_prefill(self, *, uid: int, tier: Optional[str], prompt_len: int,
                   t0: float, ticks: float, fence: Any = None) -> None:
        _bump()
        if self.profiler is not None and fence is not None:
            self.profiler.fence(fence, "prefill")
        self.tracer.dispatch(
            "prefill", t0, ticks=ticks, ticks_end=ticks,
            args={"uid": uid, "tier": tier, "prompt_len": prompt_len})
        if self.profiler is not None:
            self.profiler.record("prefill", self.wall() - t0)

    def on_decode_chunk(self, *, t0: float, ticks0: float, ticks_end: float,
                        n_steps: int, lanes: Sequence[Lane],
                        groups: Any = None, fence: Any = None,
                        dispatches: Optional[int] = None) -> None:
        _bump()
        if self.profiler is not None and fence is not None:
            self.profiler.fence(fence, "decode_chunk")
        layout = format_group_layout(tuple(groups)) if groups else ""
        self.tracer.dispatch(
            "decode_chunk", t0, ticks=ticks0, ticks_end=ticks_end,
            args={"n_steps": n_steps, "layout": layout,
                  "active_lanes": sum(1 for _, a in lanes if a)})
        self._account(lanes, n_steps)
        if self.profiler is not None:
            self.profiler.record("decode_chunk", self.wall() - t0)
            if dispatches is not None and layout:
                self.profiler.record_dispatch_count(layout, dispatches)

    def on_spec_round(self, *, t0: float, ticks0: float, ticks_end: float,
                      k: int, draft_lanes: Sequence[Lane],
                      verify_lanes: Sequence[Lane],
                      fence: Any = None,
                      args: Optional[Dict[str, Any]] = None) -> None:
        _bump()
        if self.profiler is not None and fence is not None:
            self.profiler.fence(fence, "spec_round")
        merged: Dict[str, Any] = {"k": k}
        merged.update(args or {})
        self.tracer.dispatch("spec_round", t0, ticks=ticks0,
                             ticks_end=ticks_end, args=merged)
        self._account(draft_lanes, k)
        self._account(verify_lanes, 1)
        if self.profiler is not None:
            self.profiler.record("spec_round", self.wall() - t0)

    def on_migrate(self, *, uid: int, old_tier: Optional[str],
                   new_tier: str, kv: bool, ticks: float,
                   t0: Optional[float] = None, fence: Any = None) -> None:
        _bump()
        if self.profiler is not None and fence is not None:
            self.profiler.fence(fence, "migrate_kv")
        self.tracer.engine_instant(
            "migrate", ticks=ticks,
            args={"uid": uid, "from": old_tier, "to": new_tier, "kv": kv})
        if self.profiler is not None and t0 is not None:
            self.profiler.record("migrate_kv", self.wall() - t0)

    # ------------------------------------------------------------- syncing
    def sync_stats(self, stats: Any,
                   queue_depth: Optional[int] = None) -> None:
        """Mirror ``EngineStats`` into the registry and refresh the derived
        gauges.  The engine calls this after every state-changing op, so
        the fuzz harness can assert twin equality at any point."""
        _bump()
        sync_engine_stats(self.registry, stats)
        r = self.registry
        r.gauge("serve_slot_utilization").set(
            slot_utilization(stats, self._num_slots))
        util = self._useful_cycles / self._issued_cycles \
            if self._issued_cycles else 0.0
        r.gauge("serve_modeled_cycle_utilization").set(util)
        r.gauge("serve_spec_acceptance_rate").set(spec_acceptance_rate(stats))
        if queue_depth is not None:
            r.gauge("serve_queue_depth").set(float(queue_depth))

    # ------------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: metrics (+ device-profile phases when on)."""
        prof = self.profiler.snapshot() if self.profiler is not None else None
        return to_json(self.registry, prof)

    def prometheus(self) -> str:
        return to_prometheus(self.registry)

    def write_trace(self, path: str) -> None:
        self.tracer.write(path)
