"""Automatic mixed-precision search command line (port of
``repro.launch.autoprec``): model -> measured sensitivity ->
hardware-priced Pareto front -> servable PrecisionSchedule file.

    PYTHONPATH=src python -m repro_torch.launch.autoprec --arch granite-3-8b \
        --reduced --choices 2 4 6 --calib-batches 2 --calib-len 16 \
        --max-divergence 0.05 --out schedule.json

    # then serve the searched schedule (zero re-preparation, any tier):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --reduced --schedule-file schedule.json --requests 8

The backend defaults to ``cuda`` (the hand-written kernels) and the device
to ``cuda``; ``--device cpu`` runs the kernels' plain versions.  Weights
are random from ``--seed``, made and prepared layer by layer on the
device.  A schedule file names the ``cuda`` backend ``pallas``, the JAX
package's name for it, so either package serves it.

Pipeline (all through the REAL quantization path — the 8-bit superplane
store with per-layer plane-prefix truncation, never a proxy):

1. prepare the superplane store once (the same artifact an engine preloads);
2. profile per-layer sensitivity at every candidate width on calibration
   batches (batched one-pass row groups unless --sequential / MoE);
3. search: greedy marginal-divergence-per-marginal-cycle + differentiable
   relaxation (on the device), priced in modeled accelerator cycles per
   token;
4. re-measure the front's candidates JOINTLY (the additive surrogate is
   only a surrogate), print the Pareto table, select the cheapest point
   whose measured divergence stays within --max-divergence;
5. write the selected point as the default tier (``auto``) of a
   PrecisionSchedule JSON (+ a uniform-8 ``base`` tier for A/B serving),
   with the full front recorded in the file's meta.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.autoprec import (CostModel, load_schedule,
                                  measure_divergence, profile_sensitivity,
                                  random_calibration, result_to_meta,
                                  save_schedule, schedule_from_results,
                                  search)
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import LayerPrecision, PrecisionSchedule
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod


def _spread(front, k):
    """Up to k points spread evenly over the front (always includes the
    cheapest and the richest)."""
    if len(front) <= k:
        return list(front)
    idx = sorted({round(i * (len(front) - 1) / (k - 1)) for i in range(k)})
    return [front[i] for i in idx]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--choices", nargs="+", type=int, default=[2, 4, 6],
                    help="candidate per-layer weight widths (even widths "
                         "serve via plane-prefix truncation; omit 8 to "
                         "force every point below the uniform-8 baseline)")
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "decomposed"])
    ap.add_argument("--metric", default="kl", choices=["kl", "mse"])
    ap.add_argument("--strategy", default="both",
                    choices=["greedy", "relaxed", "both"])
    ap.add_argument("--lambdas", nargs="+", type=float, default=None,
                    help="relaxation sweep (default: auto log-spaced)")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=2)
    ap.add_argument("--calib-len", type=int, default=16)
    ap.add_argument("--block", type=int, default=8,
                    help="perturbations per one-pass profiling forward")
    ap.add_argument("--sequential", action="store_true",
                    help="one forward per perturbation instead of the "
                         "batched one-pass profiler")
    ap.add_argument("--eval-top", type=int, default=6,
                    help="front points to re-measure jointly")
    ap.add_argument("--max-divergence", type=float, default=0.05,
                    help="selection bound on measured joint divergence")
    ap.add_argument("--out", default=None, metavar="SCHEDULE.json",
                    help="write the selected schedule here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = LM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    # One superplane preparation serves profiling, joint evaluation AND any
    # engine later built from the emitted schedule; layer by layer, each
    # layer's float weights dropped as soon as its planes exist.
    t0 = time.time()
    prep_policy = PrecisionSchedule(tiers={"base": LayerPrecision(
        w_bits=8, a_bits=args.a_bits, backend=args.backend)}).prepare_policy()
    qpaths: list = []
    params = model.init(gen, device=device, prepare=lambda tree, prefix:
                        engine_mod.prepare_tree(tree, prep_policy,
                                                prefix=prefix,
                                                superplane=True,
                                                paths=qpaths))
    print(f"prepared {len(qpaths)} superplane weights on {device} in "
          f"{time.time()-t0:.1f}s")

    calib = random_calibration(cfg, batches=args.calib_batches,
                               batch=args.calib_batch, seq=args.calib_len,
                               seed=args.seed + 1)
    batched = None if not args.sequential else False
    t0 = time.time()
    profile = profile_sensitivity(
        model, params, calib=calib, choices=tuple(args.choices),
        a_bits=args.a_bits, metric=args.metric, backend=args.backend,
        batched=batched, block=args.block)
    print(f"profiled {len(profile.layers)} layers x "
          f"{len([b for b in profile.choices if b < 8])} widths in "
          f"{time.time()-t0:.1f}s ({args.metric})")

    cost = CostModel.for_config(cfg, a_bits=args.a_bits)
    front = search(profile.table, cost, choices=tuple(args.choices),
                   strategy=args.strategy, lambdas=args.lambdas,
                   device=device)

    # Joint re-measurement: the surrogate ranks, the measurement decides.
    eval_pts = _spread(front, max(2, args.eval_top))
    t0 = time.time()
    measured = measure_divergence(
        model, params,
        {f"pt{i}": r.assignment for i, r in enumerate(eval_pts)},
        calib=calib, a_bits=args.a_bits, metric=args.metric,
        backend=args.backend, batched=batched)
    for i, r in enumerate(eval_pts):
        r.measured_divergence = measured[f"pt{i}"]
    print(f"jointly measured {len(eval_pts)} candidates in "
          f"{time.time()-t0:.1f}s")
    # NOTE: the front stays as pruned on the surrogate — re-pruning now
    # would compare joint measurements (a subset) against surrogates (the
    # rest) on different scales and could drop the selected point from the
    # reported/persisted table.

    uniform8 = cost.uniform_cycles(8)
    print(f"\nuniform-8 baseline: {uniform8:.1f} cycles/token, "
          f"divergence 0 by definition")
    print(f"{'strategy':>8} {'avg_bits':>8} {'cycles/tok':>10} "
          f"{'vs_8bit':>8} {'pred_div':>10} {'meas_div':>10}")
    for r in front:
        meas = f"{r.measured_divergence:.3e}" \
            if r.measured_divergence is not None else "-"
        print(f"{r.strategy:>8} {r.avg_bits:>8.2f} "
              f"{r.cycles_per_token:>10.1f} "
              f"{r.cycles_per_token/uniform8:>8.2f} "
              f"{r.pred_divergence:>10.3e} {meas:>10}")

    # Selection: cheapest measured point within the divergence budget;
    # fall back to the most accurate measured point.
    ok = [r for r in eval_pts
          if r.measured_divergence is not None
          and r.measured_divergence <= args.max_divergence]
    if ok:
        selected = min(ok, key=lambda r: r.cycles_per_token)
    else:
        selected = min(eval_pts,
                       key=lambda r: (r.measured_divergence or 0.0))
        print(f"WARNING: no candidate within --max-divergence "
              f"{args.max_divergence}; selecting the most accurate point")
    print(f"\nselected: avg_bits={selected.avg_bits:.2f} "
          f"cycles/token={selected.cycles_per_token:.1f} "
          f"({selected.cycles_per_token/uniform8:.2f}x uniform-8) "
          f"measured_div={selected.measured_divergence:.3e}")

    schedule = schedule_from_results(
        [selected], tier_names=["auto"], backend=args.backend,
        include_base=True)
    out = {"front": front, "selected": selected, "schedule": schedule,
           "profile": profile, "cost": cost, "path": args.out}
    if args.out:
        meta = {
            "arch": cfg.name, "a_bits": args.a_bits, "metric": args.metric,
            "choices": list(profile.choices),
            "calib": {"batches": args.calib_batches,
                      "batch": args.calib_batch, "seq": args.calib_len,
                      "seed": args.seed + 1},
            "uniform8_cycles_per_token": uniform8,
            "max_divergence": args.max_divergence,
            "selected": result_to_meta(selected),
            "pareto_front": [result_to_meta(r) for r in front],
        }
        save_schedule(args.out, schedule, meta=meta)
        load_schedule(args.out)      # fail fast if the file can't serve
        print(f"wrote {args.out} (tiers: {list(schedule.tier_names)}, "
              f"default {schedule.default_tier!r})")
    return out


if __name__ == "__main__":
    main()
