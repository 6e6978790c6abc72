"""Serving command line (port of ``repro.launch.serve``): quantize a model once
into its plane store and serve a stream of requests through the streaming
engine (``submit`` / ``step`` / ``drain``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --w-bits 4 --kv-bits 8 --requests 8

Runtime precision tiers (one 8-bit superplane preload, per-request
effective precision; requests round-robin over the tiers and decode in
mixed-tier batches):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --tiers 8/8 4/4 2/2 --requests 9

``--packed`` prepares the byte-packed store (one uint8 per weight in place
of int8 planes; even widths only, odd ``--w-bits`` keep their planes).

Seeded sampling (``--temperature``, ``--top-k``) and self-speculative
decoding (``--speculate``: draft ``--spec-k`` tokens a round at the
``--draft-tier`` plane prefix, verify the window in one forward at each
request's own tier):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --speculate --draft-tier 2/2 --spec-k 4 \
        --device cpu

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
from repro_torch.spec.sampling import SamplingParams
from repro_torch.spec.speculate import SpecConfig


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
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding: draft --spec-k tokens "
                         "per round at the --draft-tier plane prefix, "
                         "verify the window in one batched forward at each "
                         "request's own tier (needs --tiers)")
    ap.add_argument("--draft-tier", default=None, metavar="W/A",
                    help="with --speculate: the draft tier, one of --tiers "
                         "(default: the last)")
    ap.add_argument("--spec-k", type=int, default=4, metavar="K",
                    help="with --speculate: draft tokens per round")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0, metavar="K",
                    help="with --temperature > 0: sample among the K most "
                         "likely tokens (0 = the whole vocabulary)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # Flag checks before any model is built.
    if args.speculate:
        if not args.tiers:
            ap.error("--speculate drafts at a plane-prefix tier; it needs "
                     "--tiers")
        if args.spec_k < 1:
            ap.error(f"--spec-k must be >= 1, got {args.spec_k}")
        if args.draft_tier is None:
            args.draft_tier = args.tiers[-1]
        elif args.draft_tier not in args.tiers:
            ap.error(f"--draft-tier {args.draft_tier} is not one of the "
                     f"serving tiers {args.tiers}")
    elif args.draft_tier is not None:
        ap.error("--draft-tier needs --speculate")
    if args.temperature < 0.0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    if args.top_k < 0:
        ap.error(f"--top-k must be >= 0, got {args.top_k}")

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
    sampling = None
    if args.temperature > 0.0 or args.top_k > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, seed=args.seed)
    spec = SpecConfig(draft_tier=args.draft_tier, k=args.spec_k) \
        if args.speculate else None
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=4 + i % 5).astype(np.int32),
                    max_new_tokens=1 + (args.max_new * (i % 4)) // 3,
                    tier=tier_of(i), sampling=sampling, spec=spec)
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
    if args.speculate:
        rate = st.spec_accepted / st.spec_drafted if st.spec_drafted else 0.0
        print("spec " + json.dumps({
            "spec_rounds": st.spec_rounds,
            "spec_draft_steps": st.spec_draft_steps,
            "spec_verify_steps": st.spec_verify_steps,
            "spec_drafted": st.spec_drafted,
            "spec_accepted": st.spec_accepted,
            "spec_emitted": st.spec_emitted,
            "acceptance_rate": rate}, sort_keys=True))
    return results


if __name__ == "__main__":
    main()
