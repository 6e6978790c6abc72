"""Runs one cell of the benchmark of the port (``repro_torch``) once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` in a
traced run, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  Exits 1 without a result when
no card is there, and when the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library may load JAX or Flax."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT / "bench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from benchlib import cell as cell_mod
    spec = cell_mod.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    chips = cell_mod.chips_of(ROOT, args.workload)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              "found", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    result = cell_mod.run(spec, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    found = cell_mod.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    print(cell_mod.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
