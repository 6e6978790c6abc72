"""One run of one cell: the engine built and warmed up (set-up), the loop
over the window, the metrics, the check, and the result's last line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own under ``bench/``, found by the names
in ``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from benchlib import judge, stats
from benchlib.serve import Driver, Rec, Tracer, Window, build_engine
from benchlib.traffic import Traffic

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """A cell's parts, read from its files."""

    name: str
    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(name, cfg, mix, limits["limits"],
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the configuration and mix, the
    window's requests and engine counters, and the traced stretch."""

    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    recs: List[Rec]
    window: Window
    traced: Optional[Dict[str, Any]]

    def delta(self, key: str) -> float:
        return self.window.stats1[key] - self.window.stats0[key]

    def in_window(self, t: float) -> bool:
        return self.window.t_open < t <= self.window.t_end

    def decode_contexts(self) -> List[int]:
        """Context length of every token a decode step emitted in the
        window (a request's first token comes from its prefill)."""
        return [len(r.planned.prompt) + j
                for r in self.recs for j, t in enumerate(r.times)
                if j > 0 and self.in_window(t)]

    def window_prompts(self) -> List[int]:
        """Prompt lengths of the requests prefilled in the window."""
        return [len(r.planned.prompt) for r in self.recs
                if r.times and self.in_window(r.times[0])]

    def spans(self, label: str) -> List[Any]:
        if self.traced is None:
            return []
        return [s for s in self.traced["spans"] if s.label == label]

    def ops(self) -> List[Any]:
        return [] if self.traced is None else self.traced["trace"].ops


def load_reader(name: str) -> Callable[[Context], Optional[float]]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    assert spec.loader is not None
    spec.loader.exec_module(mod)
    return mod.read


def card(device: torch.device) -> Dict[str, Any]:
    info: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda"
                            else device.type, "count": 1}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            info["power_limit_w"] = float(smi.stdout.split()[0])
    else:
        info["kind"] = "cpu"
    return info


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, Flax's or the JAX package's, compared whole: ``repro_torch``
    is not ``repro``."""
    loaded = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in loaded} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        grace_s: float = 60.0, control: bool = False) -> Dict[str, Any]:
    """One run; returns the result object (``correct`` included)."""
    cfg, mix = cell.cfg, cell.mix
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    engine = build_engine(cfg, mix, seed, device)
    print(f"set-up: imports {t_build - t_start:.3f} s, engine built "
          f"{time.perf_counter() - t_build:.3f} s", file=sys.stderr)
    traffic = Traffic(mix, seed, cfg["vocab_size"])
    tracer = None
    if trace:
        t = mix.get("trace", {})
        tracer = Tracer(engine, device, t.get("min_chunks", 3),
                        t.get("min_prefills", 0), t.get("max_steps", 8))
    drv = Driver(engine, traffic, tracer)
    if mix["loop"] == "closed":
        win = drv.run_closed(seconds)
    else:
        win = drv.run_open(seconds, grace_s)
    setup_s = win.t_open - t_start
    recs = list(drv.recs.values())
    mem = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    metrics: Dict[str, Dict[str, Any]] = {}
    load = {"queue_at_close": float(drv.queue_at_close),
            "late_p90_s": stats.percentile(drv.late_s, 90),
            "device_allocs_in_window": win.stats1["device_allocs"]
            - win.stats0["device_allocs"],
            "alloc_retries_in_window": win.stats1["alloc_retries"]
            - win.stats0["alloc_retries"]}
    if mix["loop"] == "closed":
        attempted = sum(1 for r in recs if r.times and any(
            win.t_open < t <= win.t_end for t in r.times))
        failed = 0
        e2e = {"tokens_per_s": stats.rate(recs, win)}
    else:
        e2e, attempted, failed = stats.open_loop(recs, win, seconds)
        load.update({k: v for k, v in e2e.items()
                     if k not in {m["name"] for m in cell.end_to_end}})
    e2e["peak_mem_gb"] = mem / 1e9
    e2e["setup_s"] = setup_s
    ctx = Context(cfg, mix, recs, win, win.traced)
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = card(device)
    dev_info["memory_peak_bytes"] = int(mem)
    result: Dict[str, Any] = {"attempted": attempted, "failed": failed,
                              "metrics": metrics, "device": dev_info}
    if trace and win.traced is not None:
        from benchlib import trace as tr
        dt = win.traced["trace"]
        dev_info["busy_s"] = tr.busy_us([(o.start, o.end)
                                         for o in dt.ops]) / 1e6
        dev_info["window_s"] = dt.window_us / 1e6
        result["breakdown"] = tr.breakdown(dt, win.traced["spans"])
    # The check, once the window has closed and the engine is freed.
    sample = judge.pick(recs, seed, int(mix["check"]["per_tier"]))
    engine = drv = tracer = None
    win.traced = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = judge.readings(cfg, seed, recs, sample, device, control)
    values["check_s"] = time.perf_counter() - t_check
    values.update(load)
    ok, checks = judge.judge(values, cell.limits)
    result["correct"] = bool(ok)
    result["readings"] = values
    if control:
        # The control in the program's place, through the same judge.
        c_ok, c_checks = judge.judge(judge.control_values(values),
                                     cell.limits)
        result["control_correct"] = bool(c_ok)
        result["control_checks"] = c_checks
    result["checks"] = checks
    judge.print_checks(checks, values)
    return {"correct": result.pop("correct"), **result}


def dumps(result: Dict[str, Any]) -> str:
    """The result line, ``checks`` last."""
    checks = result.pop("checks", None)
    if checks is not None:
        result["checks"] = checks
    return json.dumps(result)




def chips_of(root: pathlib.Path, name: str) -> int:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return int({w["name"]: w for w in spec["workloads"]}[name]["chips"])
