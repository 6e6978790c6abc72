"""The system under test and the load on it: the serving engine of the
port built from a configuration file and the seeded float weights, and
the closed or open loop that drives it through its public entry points
(``ServeEngine.submit`` / ``step``, each token's time taken by a
``RequestHandle.on_token`` callback as the engine streams it)."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchlib import weights
from benchlib.traffic import Planned, Traffic

# ArchConfig fields a configuration file may set.
ARCH_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
             "num_kv_heads", "d_ff", "vocab_size", "head_dim", "qk_norm",
             "rope_theta", "ssm", "ssm_state", "ssm_headdim", "ssm_conv",
             "ssm_expand", "ssm_chunk", "tie_embeddings", "dtype_str")
# Request ids of the set-up's shape warm-up, apart from the traffic's.
WARM_UID = 1 << 40


def build_engine(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: torch.device) -> Any:
    """The port's ``ServeEngine`` for ``cfg`` with the mix's slot settings,
    handed the float weights of ``seed`` (it prepares its own store)."""
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.layers import Runtime
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    arch = ArchConfig(**{k: cfg[k] for k in ARCH_KEYS if k in cfg})
    sched = uniform_schedule({t: tuple(b) for t, b in cfg["tiers"].items()},
                             backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    eng = mix["engine"]
    return ServeEngine(LM(arch), weights.make_params(cfg, seed, device), rt,
                       max_batch=eng["max_batch"], max_len=eng["max_len"],
                       decode_chunk=eng.get("decode_chunk", 8),
                       prompt_bucket=eng.get("prompt_bucket", 8),
                       packed=cfg.get("store") == "packed", device=device)


@dataclasses.dataclass
class Rec:
    """One request as the benchmark saw it (host perf_counter seconds)."""

    planned: Planned
    due: float
    submitted: float
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    t_open: float
    t_end: float          # end of the last engine step the window started
    t_stop: float         # when the driver stopped (open loop: past close)
    stats0: Dict[str, float]
    stats1: Dict[str, float]
    traced: Optional[Dict[str, Any]] = None


def stats_of(engine: Any) -> Dict[str, float]:
    """The engine's counters, and the allocator's: blocks taken from the
    device (``cudaMalloc``) and frees of the whole cache to retry one."""
    s = engine.stats
    mem = torch.cuda.memory_stats() if torch.cuda.is_available() else {}
    return {"prefills": s.prefills, "prefill_seconds": s.prefill_seconds,
            "decode_steps": s.decode_steps,
            "decode_seconds": s.decode_seconds,
            "decode_chunks": s.decode_chunks,
            "decode_slot_steps": s.decode_slot_steps,
            "device_allocs": float(mem.get("num_device_alloc", 0)),
            "alloc_retries": float(mem.get("num_alloc_retries", 0))}


class Driver:
    """Submits the traffic's requests and steps the engine."""

    def __init__(self, engine: Any, traffic: Traffic,
                 tracer: Optional[Any] = None, uid_base: int = 0) -> None:
        self.engine = engine
        self.uid_base = uid_base
        self.queue_at_close = 0
        self.late_s: List[float] = []
        self.traffic = traffic
        self.mix = traffic.mix
        self.recs: Dict[int, Rec] = {}
        self.tracer = tracer
        self._next = 0

    def submit(self, planned: Planned, due: float) -> None:
        from repro_torch.serve.request import Request
        rec = Rec(planned, due, time.perf_counter())
        self.recs[planned.index] = rec
        self.late_s.append(rec.submitted - due)

        def on_token(ev: Any, rec: Rec = rec) -> None:
            rec.times.append(time.perf_counter())
            rec.tokens.append(int(ev.token))
        handle = self.engine.submit(Request(
            uid=self.uid_base + planned.index, prompt=planned.prompt,
            max_new_tokens=planned.max_new, tier=planned.tier))
        handle.on_token(on_token)

    def _step(self) -> List[Any]:
        events = self.engine.step()
        if self.tracer is not None:
            self.tracer.after_step(self)
        return events

    # ---------------------------------------------------------- closed loop
    def _resubmit(self, events: List[Any]) -> None:
        for ev in events:
            if ev.final:
                self.submit(self.traffic.request(self._next), time.perf_counter())
                self._next += 1

    def run_closed(self, seconds: float, warm_steps: int = 2) -> Window:
        """Every client's first request at once (the slot fill), ``warm_steps``
        steps, then steps until ``seconds`` have passed; each finished
        request's client sends its next at once."""
        clients = int(self.mix["clients"])
        now = time.perf_counter()
        for _ in range(clients):
            self.submit(self.traffic.request(self._next), now)
            self._next += 1
        for _ in range(warm_steps):
            self._resubmit(self.engine.step())
        stats0 = stats_of(self.engine)
        t_open = time.perf_counter()
        if self.tracer is not None:
            self.tracer.arm(t_open, seconds)
        t_end = t_open
        while t_end - t_open < seconds:
            self._resubmit(self._step())
            t_end = time.perf_counter()
        return Window(t_open, t_end, t_end, stats0, stats_of(self.engine),
                      self.tracer.result() if self.tracer else None)

    # ------------------------------------------------------------ open loop
    def warm_prompt_shapes(self) -> None:
        """One prefill of every prompt shape (bucket) the mix sends, tiers
        in turn, each a request of one token, so that no prefill shape is
        first met in the window.  (A closed loop needs none: its slot fill
        is the first block, which holds every prompt length of the mix.)"""
        from repro_torch.serve.request import Request
        bucket = int(self.mix["engine"].get("prompt_bucket", 8))
        shapes = sorted({-(-int(n) // bucket) * bucket
                         for n in self.traffic.prompt_lengths()})
        tiers = list(self.mix["tiers"])
        for j, n in enumerate(shapes):
            self.engine.submit(Request(
                uid=WARM_UID + j, prompt=np.ones((n,), np.int32),
                max_new_tokens=1, tier=tiers[j % len(tiers)]))
        while self.engine.has_work:
            self.engine.step()

    def run_open(self, seconds: float, grace_s: float) -> Window:
        """Every prompt shape warmed, then arrivals from ``warmup_s``
        before the window opens; after the close the load goes on until
        every request due in the window has finished, or ``grace_s`` has
        passed."""
        self.warm_prompt_shapes()
        warm = float(self.mix["warmup_s"])
        dues = self.traffic.arrivals(warm + seconds + grace_s)
        t_load = time.perf_counter()
        t_open = t_load + warm
        t_close = t_open + seconds
        stats0: Optional[Dict[str, float]] = None
        stats1: Optional[Dict[str, float]] = None
        t_end = t_close
        i = 0
        while True:
            now = time.perf_counter()
            if stats0 is None and now >= t_open:
                stats0 = stats_of(self.engine)
                t_open = now
                t_close = t_open + seconds
                if self.tracer is not None:
                    self.tracer.arm(t_open, seconds)
            while i < len(dues) and t_load + dues[i] <= now:
                self.submit(self.traffic.request(i), t_load + dues[i])
                i += 1
            if stats1 is None and now >= t_close:
                stats1 = stats_of(self.engine)
                t_end = now
                self.queue_at_close = len(self.engine.scheduler.waiting)
            if stats1 is not None and (self._window_done(t_open, t_close)
                                       or now >= t_close + grace_s):
                break
            if self.engine.has_work:
                self._step()
            elif i < len(dues):
                time.sleep(max(0.0, min(0.002, t_load + dues[i] - now)))
            else:
                break
        assert stats0 is not None
        if stats1 is None:
            stats1, t_end = stats_of(self.engine), time.perf_counter()
        return Window(t_open, t_end, time.perf_counter(), stats0, stats1,
                      self.tracer.result() if self.tracer else None)

    def _window_done(self, t_open: float, t_close: float) -> bool:
        return all(len(r.tokens) >= r.planned.max_new
                   for r in self.recs.values() if t_open <= r.due < t_close)


class Tracer:
    """Profiles a stretch of engine steps inside the window of a traced
    run: it starts after a third of the window and stops once it has seen
    ``min_chunks`` decode chunks and ``min_prefills`` prefills, or after
    ``max_steps`` steps."""

    def __init__(self, engine: Any, device: torch.device,
                 min_chunks: int, min_prefills: int, max_steps: int) -> None:
        from benchlib import trace
        self.trace_mod = trace
        self.engine = engine
        self.device = device
        self.min_chunks, self.min_prefills = min_chunks, min_prefills
        self.max_steps = max_steps
        self.rec = trace.Recorder()
        model = engine.model
        self.rec.wrap(engine, "step", "step")
        self.rec.wrap(model, "prefill", "prefill", info=_prefill_info)
        self.rec.wrap(model, "decode_step", "decode_step",
                      info=_decode_info)
        trace.DeviceTrace.warm(device)
        self.dev_trace: Optional[Any] = None
        self.t_begin = float("inf")
        self.steps = 0
        self.s0: Optional[Dict[str, float]] = None
        self.done = False

    def arm(self, t_open: float, seconds: float) -> None:
        self.t_begin = t_open + seconds / 3.0

    def after_step(self, driver: Driver) -> None:
        if self.done:
            return
        if self.dev_trace is None:
            if time.perf_counter() >= self.t_begin:
                self.dev_trace = self.trace_mod.DeviceTrace(self.device)
                self.s0 = stats_of(self.engine)
                self.dev_trace.start()
                self.rec.on = True
            return
        self.steps += 1
        s = stats_of(self.engine)
        seen = (s["decode_chunks"] - self.s0["decode_chunks"],
                s["prefills"] - self.s0["prefills"])
        if (seen[0] >= self.min_chunks and seen[1] >= self.min_prefills) \
                or self.steps >= self.max_steps:
            self._stop()

    def _stop(self) -> None:
        self.dev_trace.stop()
        self.rec.on = False
        self.done = True
        self.s1 = stats_of(self.engine)
        print(f"traced {self.steps} engine steps, "
              f"{len(self.rec.spans)} host spans", file=sys.stderr)

    def result(self) -> Optional[Dict[str, Any]]:
        if self.dev_trace is not None and not self.done:
            self._stop()
        self.rec.unwrap()
        if self.done:
            self.dev_trace.collect()
        if not self.done:
            print("trace: the window closed before the traced stretch "
                  "began", file=sys.stderr)
            return None
        return {"trace": self.dev_trace, "spans": self.rec.spans,
                "stats0": self.s0, "stats1": self.s1}


def _prefill_info(args, kwargs) -> Dict[str, Any]:
    rt = args[1]
    tokens = kwargs.get("tokens")
    return {"rows": int(tokens.shape[0] * tokens.shape[1]), "tier": rt.tier}


def _decode_info(args, kwargs) -> Dict[str, Any]:
    rt = args[1]
    tokens = kwargs.get("tokens")
    return {"rows": int(tokens.shape[0]),
            "groups": tuple(rt.groups) if rt.groups is not None
            else ((rt.tier, int(tokens.shape[0])),)}

