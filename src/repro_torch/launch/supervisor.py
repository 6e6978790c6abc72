"""Fleet supervisor: heartbeat-based straggler detection + elastic restart
(port of ``repro.launch.supervisor``; plain Python, the reference's logic).

At 1000+ nodes the failure model is: hosts die, hang, or straggle.  An
SPMD program cannot drop a participant mid-program, so the production
pattern is supervisor-level: detect (missed heartbeats / slow steps),
evict, re-mesh with the survivors, and resume from the latest checkpoint
(the checkpoint layer stores global arrays, so any world size can
restore them).

This module is the single-process simulation of that control loop, used by
the launcher and validated in tests: worker processes send heartbeats; the
supervisor times out stragglers, shrinks the world, and re-assigns work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class WorkerState:
    uid: int
    last_heartbeat: float
    step: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True

    def median_step_time(self) -> float:
        if not self.step_times:
            return 0.0
        s = sorted(self.step_times[-16:])
        return s[len(s) // 2]


@dataclasses.dataclass
class SupervisorConfig:
    heartbeat_timeout_s: float = 60.0
    # A worker whose median step time exceeds `straggler_factor` x the fleet
    # median for `straggler_patience` consecutive checks is evicted.
    straggler_factor: float = 2.0
    straggler_patience: int = 3
    min_workers: int = 1


class Supervisor:
    """Tracks worker heartbeats/step times; decides evictions + re-mesh."""

    def __init__(self, cfg: SupervisorConfig = SupervisorConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.workers: Dict[int, WorkerState] = {}
        self._strikes: Dict[int, int] = {}
        self.generation = 0           # bumps on every re-mesh

    # ------------------------------------------------------------ bookkeeping
    def register(self, uid: int):
        self.workers[uid] = WorkerState(uid=uid, last_heartbeat=self.clock())
        self._strikes[uid] = 0

    def heartbeat(self, uid: int, step: int, step_time_s: float):
        w = self.workers[uid]
        w.last_heartbeat = self.clock()
        w.step = step
        w.step_times.append(step_time_s)

    # --------------------------------------------------------------- policy
    def fleet_median_step(self) -> float:
        times = [w.median_step_time() for w in self.workers.values()
                 if w.alive and w.step_times]
        if not times:
            return 0.0
        times.sort()
        return times[len(times) // 2]

    def check(self) -> List[int]:
        """Returns newly-evicted worker uids (dead or persistent stragglers)."""
        now = self.clock()
        fleet = self.fleet_median_step()
        evicted = []
        alive = [w for w in self.workers.values() if w.alive]
        for w in alive:
            if len([x for x in self.workers.values() if x.alive]) \
                    <= self.cfg.min_workers:
                break
            if now - w.last_heartbeat > self.cfg.heartbeat_timeout_s:
                w.alive = False
                evicted.append(w.uid)
                continue
            if fleet > 0 and w.median_step_time() > \
                    self.cfg.straggler_factor * fleet:
                self._strikes[w.uid] += 1
                if self._strikes[w.uid] >= self.cfg.straggler_patience:
                    w.alive = False
                    evicted.append(w.uid)
            else:
                self._strikes[w.uid] = 0
        if evicted:
            self.generation += 1
        return evicted

    def alive_workers(self) -> List[int]:
        return sorted(w.uid for w in self.workers.values() if w.alive)

    def remesh_plan(self, chips_per_worker: int) -> dict:
        """The new world: survivors, their mesh, and the resume step
        (min over survivors — conservative; the checkpoint layer re-shards)."""
        alive = self.alive_workers()
        resume = min((self.workers[u].step for u in alive), default=0)
        return {
            "generation": self.generation,
            "workers": alive,
            "n_chips": len(alive) * chips_per_worker,
            "resume_step": resume,
        }
