#!/usr/bin/env python3
"""Two trees of the port on one card, in one process each, in the order
A B B A: the attention core and the paths that run it.

    python3 tools/attention_ab.py --trees build/ab/parent .   # on a card

Each run is a fresh process that puts the tree's root (and, through its
``chip_smoke``, its ``src``) first on ``sys.path``, builds the tree's
kernels and measures, at the shapes of ``chip_smoke.py``:

* ``decode_attention``: phase 3's arena (B 8, S 256, 32 heads, 8 KV heads,
  bf16, each slot half full); ``flash_attention`` (prefill): phase 3's
  prompt buckets (Sq 16..64 by 8 against Sk 256, B 1) and one long prompt
  (Sq = Sk = 4096, four K/V blocks).  For each, the device ms (median of
  CUDA events, the host given a head start) and the wall ms a call of 50
  back-to-back calls (the host's launches included);
* phase 3's serving run (full-width qwen3-8b, 36 layers, seed 0, tiers
  8/8 4/4 2/2, the same nine requests): mean decode-step ms, prefill
  seconds, launches and the streams; then one 4000-token prompt through an
  engine of ``max_len`` 4096 on the same store (its prefill seconds);
* phase 4g (a)'s train step (``launch.train.main`` at
  ``TRAIN_FULL_ARGV``, 10 steps): median ms of steps 2-10.

Prints each run's JSON on a line, then a summary line: per metric the
mean of each tree's two runs and their ratio (B / A), and whether each
tree's streams are the same in both its runs and across the trees.  Logs
go to ``chiprun_out/attention_ab/``.
"""
import argparse
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

OUT = pathlib.Path("chiprun_out") / "attention_ab"
LONG_PROMPT = 4000
TRAIN_STEPS = 10


def _timed(fn, reps: int = 25, warm: int = 3) -> dict:
    """Device ms (median of CUDA events, each call after a head start of
    ~1 ms) and wall ms a call over 50 back-to-back calls."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    return {"device_ms": statistics.median(times),
            "wall_ms": 1e3 * (time.perf_counter() - t0) / 50}


def _attention(cs) -> dict:
    import torch

    from repro_torch.models import layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    b, s, h, kvh, dh = 8, cs.MIXED_KW["max_len"], 32, 8, 128
    out = {}
    cache = layers.KVCache.create(b, s, kvh, dh, device="cuda")
    cache.update(rnd(b, s, kvh, dh), rnd(b, s, kvh, dh), 0,
                 new_length=torch.full((b,), s // 2, device="cuda"))
    q = rnd(b, 1, h, dh)
    with torch.inference_mode():
        out["decode_attention"] = _timed(
            lambda: layers.decode_attention(q, cache))
        for sq in range(16, 65, 8):
            q, k, v = rnd(1, sq, h, dh), rnd(1, s, kvh, dh), rnd(1, s, kvh, dh)
            out[f"prefill_sq{sq}"] = _timed(
                lambda: layers.flash_attention(q, k, v, causal=True))
        n = 4096
        q, k, v = rnd(1, n, h, dh), rnd(1, n, kvh, dh), rnd(1, n, kvh, dh)
        out[f"prefill_sq{n}"] = _timed(
            lambda: layers.flash_attention(q, k, v, causal=True), reps=5)
    return out


def _serving(cs) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request
    cfg = get_config("qwen3-8b")
    sched = uniform_schedule(cs.TIERS, backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    _, model, params = cs._build_model(cfg.num_layers, sched.prepare_policy(),
                                       superplane=True, seed=0)
    reqs = cs._requests(9, cfg.vocab_size, 16, list(cs.TIERS), seed=1)
    res = cs._serve(ServeEngine(model, params, rt, **cs.MIXED_KW), reqs,
                    "ab-mixed")
    long_kw = dict(cs.MIXED_KW, max_batch=1, max_len=4096)
    rng = np.random.default_rng(2)
    long_req = Request(uid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=LONG_PROMPT).astype(np.int32),
        max_new_tokens=2, tier="8/8")
    long = cs._serve(ServeEngine(model, params, rt, **long_kw),
                     [long_req], "ab-long")
    st = res["stats"]
    return {"mean_decode_step_ms": st["mean_decode_step_ms"],
            "prefill_s": st["prefill_s"], "launches": st["launches"],
            "tokens": {str(k): v for k, v in sorted(res["tokens"].items())},
            "long_prefill_s": long["stats"]["prefill_s"],
            "long_tokens": long["tokens"][0]}


def _train(cs) -> dict:
    argv = list(cs.TRAIN_FULL_ARGV)
    argv[argv.index("--steps") + 1] = str(TRAIN_STEPS)
    _, rec, peak = cs._train_cli(argv, "ab-train")
    return {"train_step_ms": statistics.median(r["ms"] for r in rec[1:]),
            "train_peak_gb": peak}


def worker(tree: str) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import chip_smoke as cs
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    res = {"tree": tree}
    if hasattr(cs, "_head_slices"):       # phase 4h (c), where the tree has it
        res.update({f"head_slices_{k}": v
                    for k, v in cs._head_slices().items()})
    for part in (_attention, _train, _serving):   # training needs ~72 GB
        res.update(part(cs))
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def _summary(runs) -> dict:
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = {t: [r for r in runs if r["tree"] == t] for t in trees}
    a, b = trees
    out = {"trees": trees, "order": [r["tree"] for r in runs]}
    metrics = {}
    for key, val in runs[0].items():
        if isinstance(val, dict) and "device_ms" in val:
            for sub in ("device_ms", "wall_ms"):
                metrics[f"{key}.{sub}"] = [r[key][sub] for r in runs]
        elif isinstance(val, float):
            metrics[key] = [r[key] for r in runs]
    for key in metrics:
        ma = statistics.mean(r for r, run in zip(metrics[key], runs)
                             if run["tree"] == a)
        mb = statistics.mean(r for r, run in zip(metrics[key], runs)
                             if run["tree"] == b)
        metrics[key] = {"runs": metrics[key], "a": ma, "b": mb,
                        "b_over_a": mb / ma}
    out["metrics"] = metrics
    for t in trees:
        out[f"streams_repeat[{t}]"] = by[t][0]["tokens"] == by[t][1]["tokens"]
    out["streams_equal_across"] = by[a][0]["tokens"] == by[b][0]["tokens"]
    out["uids_differing"] = [u for u in by[a][0]["tokens"]
                             if by[a][0]["tokens"][u] != by[b][0]["tokens"][u]]
    out["long_tokens_equal"] = by[a][0]["long_tokens"] == \
        by[b][0]["long_tokens"]
    out["launches_equal"] = by[a][0]["launches"] == by[b][0]["launches"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    a, b = args.trees
    runs = []
    for i, tree in enumerate((a, b, b, a)):
        log = OUT / f"run{i}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--worker", tree],
                                  stdout=subprocess.PIPE, stderr=f, text=True,
                                  env=dict(os.environ, PYTHONUNBUFFERED="1"))
            f.write(proc.stdout)
        if proc.returncode != 0:
            print(f"run {i} ({tree}) failed with {proc.returncode}; see {log}")
            print(open(log).read()[-4000:])
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"run {i} ({tree}) {time.perf_counter() - t0:.1f}s: "
              + json.dumps({k: v for k, v in runs[-1].items()
                            if k not in ("tokens", "long_tokens")}),
              flush=True)
    summary = _summary(runs)
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
