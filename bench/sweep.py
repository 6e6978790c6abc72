"""Finds the knee of an open-loop mix on the card: one engine (as ``run.py``
builds it for ``--seed``), then one window at each rate of ``--rates`` in
turn, each with its own arrivals and a drain between them.  Prints per
rate the TTFT and TPOT tails, the requests due and unfinished, the queue
at the window's close and how late the generator ran.  The knee is the
highest rate whose queue does not grow; a mix file records it as a number
(``knee_per_s``) and runs at a fixed share of it.  Not run by the
benchmark's runs.

    python3 bench/sweep.py --workload <cell> --seed 1 --seconds 30 \
        --rates 0.8,1.2,1.6
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--grace", type=float, default=30.0)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch
    from benchlib import cell as cell_mod
    from benchlib import stats
    from benchlib.serve import Driver, build_engine
    from benchlib.traffic import Traffic
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    spec = cell_mod.load_cell(bench_run.ROOT, args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    engine = build_engine(spec.cfg, spec.mix, args.seed, dev)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(spec.mix, rate_per_s=rate)
        drv = Driver(engine, Traffic(mix, args.seed + k, spec.cfg["vocab_size"]),
                     uid_base=(k + 1) * 1_000_000)
        win = drv.run_open(args.seconds, args.grace)
        recs = list(drv.recs.values())
        tails, due, failed = stats.open_loop(recs, win, args.seconds)
        halves = stats.ttft_halves(recs, win, args.seconds)
        unfinished = sum(1 for r in recs if win.t_open <= r.due <
                         win.t_open + args.seconds and
                         len(r.tokens) < r.planned.max_new)
        while engine.has_work:
            engine.step()
        print(json.dumps({"rate_per_s": rate, **tails, "due": due,
                          "failed": failed, "unfinished": unfinished,
                          "ttft_median_s_by_half": halves,
                          "queue_at_close": drv.queue_at_close,
                          "late_p90_s": stats.percentile(drv.late_s, 90),
                          "stopped_s_after_close":
                          win.t_stop - win.t_open - args.seconds}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
