"""Sequential orchestrator (port of ``repro.launch.dryrun_all``): run every
(arch x shape x mesh) dry-run cell as a separate process, skipping cells
whose result JSON already exists.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--multi-pod] [--force]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCHS

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cells():
    for arch in ARCHS:
        for shape in SHAPE_ORDER:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells():
        if args.only_arch and arch != args.only_arch:
            continue
        stem = f"{arch}__{shape}__{mesh_name}"
        if args.backend:
            stem += f"__{args.backend}"
        if args.tag:
            stem += f"__{args.tag}"
        path = os.path.join(args.out, stem + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {stem}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if args.multi_pod:
            cmd.append("--multi-pod")
        if args.backend:
            cmd += ["--backend", args.backend]
        if args.tag:
            cmd += ["--tag", args.tag]
        t0 = time.time()
        print(f"[run] {stem} ...", flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(f"[TIMEOUT] {stem}")
            failures.append((stem, "timeout"))
            continue
        dt = time.time() - t0
        if r.returncode != 0:
            tail = "\n".join(r.stdout.splitlines()[-3:] +
                             r.stderr.splitlines()[-12:])
            print(f"[FAIL {dt:.0f}s] {stem}\n{tail}")
            failures.append((stem, tail[-400:]))
        else:
            lines = r.stdout.splitlines() if r.stdout else []
            info = next((l for l in reversed(lines) if l.startswith("[")), stem)
            print(f"[ok {dt:.0f}s] {info.strip()}")
    print(f"\n{len(failures)} failures")
    for stem, msg in failures:
        print(" FAILED:", stem)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
