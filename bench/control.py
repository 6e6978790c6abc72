"""The control of a cell's check, on the card: for each seed, one run of
the cell as ``run.py`` makes it, with the control put in the program's
place after the window: the reference one precision step lower (weights
8 -> 4 -> 2 -> 1 bits, activations 8 -> 4 -> 2), its tokens the ones it
puts first at every position of the sampled requests' prompts and served
tokens, read in the full-precision reference.  The control's numbers go
through the same judge and limits (``limits/<cell>.json``) as the
program's.  Prints one JSON line per seed: the program's verdict
(``correct``) and the control's (``control_correct``, false where the
check separates them), each beside its checks.  Not run by the
benchmark's runs.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 45
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch
    from benchlib import cell as cell_mod
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    spec = cell_mod.load_cell(bench_run.ROOT, args.workload)
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cell_mod.run(spec, seed, args.seconds, False,
                           torch.device("cuda", 0), t0,
                           control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "metrics": res["metrics"],
                          "checks": res["checks"],
                          "control_checks": res["control_checks"],
                          "readings": res.get("readings")}), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
