"""Runs one cell as ``bench/run.py`` does, with the program's span recorder
(``repro_torch.telemetry.trace.CURRENT``) filled, and prints what the
program's spans give.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 1`` it is ``bench/run.py --trace 1``, whose tracer fills
the recorder over the traced stretch (the result line holds the four
readings of the program's spans, ``READINGS``), with the per-block table
(``benchlib.program.block_table``) on the line before the result.  With
``--trace 0`` (closed loops) it measures what recording costs, with no
profiler on: after the set-up and one window, as ``bench/run.py``'s,
the same engine runs windows of ``--seconds`` in turns with the recorder
empty and filled (``TURNS``); it prints each window's tokens per second
and decode step, the recorded windows' ``decode_host_ms``, spans per
decode step and per-block table, and what one span costs on that host.
Needs a CUDA card; no run of the benchmark itself uses it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import run as bench_run  # noqa: E402

# The per-layer metrics read from the program's spans, with the cells
# each applies to, as BENCHMARK.json lists them.
READINGS = [
    {"name": "decode_host_ms", "unit": "ms",
     "workloads": ["mamba2-1.3b.long-decode"]},
    {"name": "decode_host_ms.reason", "unit": "ms",
     "workloads": ["qwen3-8b.reason-decode"]},
    {"name": "decode_host_ms.rag", "unit": "ms",
     "workloads": ["qwen3-8b.rag-prefill"]},
    {"name": "prefill_host_ms.rag", "unit": "ms",
     "workloads": ["qwen3-8b.rag-prefill"]},
    {"name": "idle_in_blocks_share", "unit": "%",
     "workloads": ["mamba2-1.3b.long-decode"]},
    {"name": "idle_in_blocks_share.reason", "unit": "%",
     "workloads": ["qwen3-8b.reason-decode"]},
]


# The windows of the cost measurement: recorder empty (0) or filled (1),
# each side first as often.
TURNS = (0, 1, 1, 0, 0, 1, 1, 0)


def span_us(n: int = 100000) -> float:
    """What one span costs the host: a ``linear``'s begin and end, with its
    fields, in us."""
    from repro_torch.telemetry import trace as program_trace
    rec = program_trace.Tracer()
    t0 = time.perf_counter()
    for _ in range(n):
        rec.end(rec.begin("linear", name="q_proj", rows=64), launches=0)
    return 1e6 * (time.perf_counter() - t0) / n


def alternate(spec, seed: int, seconds: float, device) -> dict:
    """The cost measurement of ``--trace 0`` (see the module docstring)."""
    from benchlib import program, serve
    from benchlib.traffic import Traffic
    eng = serve.build_engine(spec.cfg, spec.mix, seed, device)
    drv = serve.Driver(eng, Traffic(spec.mix, seed, spec.cfg["vocab_size"]))
    drv.run_closed(seconds)
    windows, rec = [], None
    for on in TURNS:
        if on:
            rec = program.start(rec)       # one recorder: ids stay unique
        s0, tokens = serve.stats_of(eng), 0
        t0 = t1 = time.perf_counter()
        while t1 - t0 < seconds:
            events = eng.step()
            tokens += len(events)
            drv._resubmit(events)
            t1 = time.perf_counter()
        program.stop(rec)
        s1 = serve.stats_of(eng)
        windows.append({
            "recording": on, "tokens_per_s": tokens / (t1 - t0),
            "decode_step_ms": 1e3 * (s1["decode_seconds"]
                                     - s0["decode_seconds"])
            / (s1["decode_steps"] - s0["decode_steps"])})
    spans = program.spans_of(rec)
    steps = sum(1 for s in spans if s.label == "decode_step")
    ctx = types.SimpleNamespace(traced={"program_spans": spans})
    med = {on: {k: statistics.median(w[k] for w in windows
                                     if w["recording"] == on)
                for k in ("tokens_per_s", "decode_step_ms")}
           for on in (0, 1)}
    return {"windows": windows, "median_off": med[0], "median_on": med[1],
            "decode_host_ms": program.decode_host_ms(ctx),
            "spans_per_decode_step": len(spans) / steps if steps else None,
            "span_us": span_us(),
            "block_table": program.block_table(None, spans)}


def record_traced_stretch(serve, kept: list) -> None:
    """Keeps the traced stretch (``Tracer.result``, the program's spans in
    ``program_spans``) in ``kept``, for the per-block table."""
    result = serve.Tracer.result

    def result_(self):
        out = result(self)
        if out is not None:
            kept.append(out)
        return out

    serve.Tracer.result = result_


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch
    from benchlib import cell as cell_mod
    from benchlib import program, serve
    spec = cell_mod.load_cell(bench_run.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    if not args.trace:
        if spec.mix["loop"] != "closed":
            print("--trace 0 measures closed loops", file=sys.stderr)
            return 1
        print(json.dumps(alternate(spec, args.seed, args.seconds, device)),
              flush=True)
        return 0
    kept: list = []
    record_traced_stretch(serve, kept)
    result = cell_mod.run(spec, args.seed, args.seconds, True, device,
                          T_START)
    if kept:
        spans = kept[0]["program_spans"]
        table = program.block_table(kept[0]["trace"], spans)
        print(json.dumps({"program_spans": len(spans),
                          "block_table": table}), flush=True)
    print(cell_mod.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
