"""Serving command line (port of ``repro.launch.serve``): quantize a model once
into its plane store and serve a stream of greedy requests through the
streaming engine (``submit`` / ``step`` / ``drain``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --w-bits 4 --kv-bits 8 --requests 8

Runtime precision tiers (one 8-bit superplane preload, per-request
effective precision; requests round-robin over the tiers and decode in
mixed-tier batches):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --tiers 8/8 4/4 2/2 --requests 9

``--packed`` prepares the byte-packed store (one uint8 per weight in place
of int8 planes; even widths only, odd ``--w-bits`` keep their planes).

The backend defaults to ``cuda`` (the hand-written kernels) and the device
to ``cuda``; ``--device cpu`` runs the kernels' plain versions.  Weights
are random from ``--seed``, made and prepared layer by layer on the device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.device import resolve_device
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.request import Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8])
    ap.add_argument("--packed", action="store_true",
                    help="byte-packed store: one uint8 per weight")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "decomposed", "dense"])
    ap.add_argument("--tiers", nargs="+", default=None, metavar="W/A",
                    help="runtime precision tiers, e.g. --tiers 8/8 4/4 2/2: "
                         "ONE superplane preload, requests round-robin over "
                         "the tiers (even w only; overrides --w/a-bits)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    schedule = None
    if args.tiers:
        if args.backend == "dense":
            ap.error("--tiers needs an integer backend")
        schedule = uniform_schedule(
            {t: tuple(int(b) for b in t.split("/")) for t in args.tiers},
            backend=args.backend)
        policy = schedule.policy_for()
    else:
        policy = uniform_policy(args.w_bits, args.a_bits, backend=args.backend)
    device = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = LM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    prepare = None
    if args.backend != "dense":
        # Weight preload, layer by layer: each layer's float weights are
        # dropped as soon as its planes exist.
        prep_policy = schedule.prepare_policy() if schedule else policy

        def prepare(tree, prefix):
            return engine_mod.prepare_tree(tree, prep_policy, prefix=prefix,
                                           superplane=schedule is not None,
                                           packed=args.packed)
    t0 = time.time()
    params = model.init(gen, device=device, prepare=prepare)
    kind = ("dense" if prepare is None else
            ("superplane" if schedule else f"w{args.w_bits}")
            + f", packed={args.packed}")
    print(f"initialised {cfg.name} ({kind}) on {device} in "
          f"{time.time() - t0:.1f}s")
    rt = Runtime(policy=policy, schedule=schedule)
    engine = engine_mod.ServeEngine(
        model, params, rt, max_batch=args.max_batch, max_len=args.max_len,
        kv_bits=args.kv_bits, decode_chunk=args.decode_chunk, device=device)

    rng = np.random.default_rng(args.seed)
    tier_of = (lambda i: args.tiers[i % len(args.tiers)]) if args.tiers \
        else (lambda i: None)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=4 + i % 5).astype(np.int32),
                    max_new_tokens=1 + (args.max_new * (i % 4)) // 3,
                    tier=tier_of(i))
            for i in range(args.requests)]
    t0 = time.time()
    handles = [engine.submit(r) for r in reqs]
    events = 0
    while engine.has_work:
        events += len(engine.step())
    dt = time.time() - t0
    results = {h.uid: h.tokens for h in handles}
    toks = sum(len(v) for v in results.values())
    print(f"served {len(reqs)} requests, {toks} tokens ({events} streamed "
          f"events) in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    st = engine.stats
    print("stats " + json.dumps({
        "prefills": st.prefills, "decode_steps": st.decode_steps,
        "decode_chunks": st.decode_chunks,
        "decode_slot_steps": st.decode_slot_steps,
        "mixed_tier_chunks": st.mixed_tier_chunks,
        "decode_steps_by_tier": st.decode_steps_by_tier,
        "tokens_by_tier": st.tokens_by_tier}, sort_keys=True))
    return results


if __name__ == "__main__":
    main()
