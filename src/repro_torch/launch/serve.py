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

Every registered arch serves, the SSM, hybrid and MoE ones included
(``--arch mamba2-1.3b``, ``jamba-1.5-large-398b``,
``llama4-scout-17b-a16e``, ``grok-1-314b``); a ``--reduced`` model's MoE
layers dispatch dropless:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --reduced --tiers 8/8 4/4 2/2 --device cpu

``--packed`` prepares the byte-packed store (one uint8 per weight in place
of int8 planes; even widths only, odd ``--w-bits`` keep their planes).
``--kv-bits 8`` or ``4`` quantizes the KV cache (int8, or int4 packed two
to a byte); ``--baseline`` serves through the batch-at-a-time
``BatchServeEngine`` instead.

Per-request KV precision (one value per tier, aligned with ``--tiers``:
bf16, 8 or 4; ONE mixed per-slot KV arena), the tier-serialized mode
(one tier per decode batch), SLO-aware admission (every 3rd request gets
a tight deadline; ``--auto-tier`` retags it to a tier that fits) and
mid-stream tier migration (the first live request moves to the last
``--tiers`` entry after a few tokens, its KV lanes requantized in place):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --kv-tiers bf16 8 4 --migrate-demo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --serialize-tiers --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --slo --auto-tier --device cpu

Seeded sampling (``--temperature``, ``--top-k``) and self-speculative
decoding (``--speculate``: draft ``--spec-k`` tokens a round at the
``--draft-tier`` plane prefix, verify the window in one forward at each
request's own tier):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --speculate --draft-tier 2/2 --spec-k 4 \
        --device cpu

Overload survival on top of ``--slo``: ``--preempt`` lets a deadlined
request out of slack displace the slackest running slot (its cache is
copied to the host and resumes later without a prefill; ``--spill-dir``
writes the copies to disk instead), and ``--shed`` refuses at submit a
deadlined request that would miss.  The request stream then becomes an
overload trace: long best-effort requests fill the slots, and the urgent
ones arrive after two decode chunks, the last with a budget no tier can
serve in time.  ``--metrics`` exports the run's metrics (Prometheus text,
or JSON for a ``.json`` path), ``--trace-out`` a Chrome trace, and
``--profile`` fences every dispatch for per-phase device times:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --tiers 8/8 4/4 2/2 --slo --preempt --shed --requests 12 \
        --metrics --device cpu

A schedule searched by ``repro_torch.launch.autoprec`` (or the JAX
package's) serves with ``--schedule-file``: its tiers (``auto`` and
``base``), per-layer rules and kv_tiers come from the file:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --arch granite-3-8b --schedule-file schedule.json --device cpu

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

from repro_torch.autoprec import load_schedule
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.device import resolve_device
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.handle import RequestStatus
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import SLOPolicy
from repro_torch.spec.sampling import SamplingParams
from repro_torch.spec.speculate import SpecConfig
from repro_torch.telemetry import Telemetry, serve_report, write_json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8, 4])
    ap.add_argument("--packed", action="store_true",
                    help="byte-packed store: one uint8 per weight")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "decomposed", "dense"])
    ap.add_argument("--tiers", nargs="+", default=None, metavar="W/A",
                    help="runtime precision tiers, e.g. --tiers 8/8 4/4 2/2: "
                         "ONE superplane preload, requests round-robin over "
                         "the tiers (even w only; overrides --w/a-bits)")
    ap.add_argument("--schedule-file", default=None, metavar="SCHEDULE.json",
                    help="serve a searched PrecisionSchedule written by "
                         "repro_torch.launch.autoprec (or the JAX package's "
                         "autoprec): tiers, per-layer rules and kv_tiers "
                         "come from the file; requests round-robin over its "
                         "tiers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--baseline", action="store_true",
                    help="serve through the batch-at-a-time BatchServeEngine")
    ap.add_argument("--kv-tiers", nargs="+", default=None, metavar="KV",
                    help="per-tier KV-cache precision aligned with --tiers "
                         "(bf16, 8 or 4): ONE mixed per-slot KV arena, each "
                         "request's slot stored at its tier's precision")
    ap.add_argument("--serialize-tiers", action="store_true",
                    help="tier-serialized admission (one tier per decode "
                         "batch) instead of mixed-tier batches")
    ap.add_argument("--slo", action="store_true",
                    help="SLO-aware admission (SLOPolicy): every 3rd request "
                         "gets a tight deadline; reports queue waits and "
                         "deadline misses")
    ap.add_argument("--preempt", action="store_true",
                    help="with --slo: a deadlined waiting request out of "
                         "slack displaces the slackest running slot (host "
                         "snapshot, prefill-free resume)")
    ap.add_argument("--shed", action="store_true",
                    help="with --slo: refuse at submit a deadlined request "
                         "whose projected completion misses (with "
                         "--auto-tier a faster tier that fits is taken "
                         "first)")
    ap.add_argument("--spill-dir", default=None, metavar="DIR",
                    help="write preempted slots' snapshots to step dirs "
                         "under DIR instead of keeping them in host memory")
    ap.add_argument("--auto-tier", action="store_true",
                    help="with --slo on a tiered engine: a deadlined request "
                         "is retagged at admission to the best tier whose "
                         "priced service time fits its deadline")
    ap.add_argument("--migrate-demo", action="store_true",
                    help="after a few tokens the first live request moves "
                         "to the last --tiers entry (its KV lanes "
                         "requantized in place; needs --tiers, mixed "
                         "admission)")
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
    ap.add_argument("--metrics", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="export the run's metrics: Prometheus text to "
                         "stdout (bare --metrics) or to PATH; a .json "
                         "suffix writes the JSON snapshot instead")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write the span trace as Chrome trace-event JSON")
    ap.add_argument("--profile", action="store_true",
                    help="fence every prefill, decode chunk and "
                         "speculative round on the device and report "
                         "per-phase seconds (same tokens, more syncs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # Flag checks before any model is built.
    kv_tiers = None
    schedule = None
    if args.schedule_file:
        if args.tiers:
            ap.error("--schedule-file carries its own tiers; drop --tiers")
        if args.kv_tiers:
            ap.error("--schedule-file carries its own kv_tiers; drop "
                     "--kv-tiers")
        if args.backend == "dense":
            ap.error("--schedule-file needs an integer backend")
        if args.baseline:
            ap.error("--baseline has no per-request tier switching; drop "
                     "--schedule-file")
        schedule = load_schedule(args.schedule_file)
        if schedule.kv_tiers is not None and args.kv_bits is not None:
            ap.error("--kv-bits conflicts with the schedule file's kv_tiers")
        # The file's pallas reads back as cuda (schedule_io).
        file_backends = {p.backend for p in schedule._all_precisions()}
        if file_backends != {args.backend}:
            ap.error(f"--backend {args.backend} does not match the schedule "
                     f"file's backend(s) {sorted(file_backends)}; pass the "
                     "matching --backend (or re-emit the file with "
                     "repro_torch.launch.autoprec --backend)")
        # Requests round-robin over the loaded tier names as over --tiers.
        args.tiers = list(schedule.tier_names)
    elif args.tiers:
        if args.baseline:
            ap.error("--baseline has no per-request tier switching "
                     "(it pins one tier); drop --tiers")
        if args.kv_tiers:
            if len(args.kv_tiers) != len(args.tiers):
                ap.error("--kv-tiers must align 1:1 with --tiers")
            if args.kv_bits is not None:
                ap.error("--kv-bits conflicts with --kv-tiers; drop one")
            try:
                kv_tiers = {t: (None if kv in ("bf16", "none") else int(kv))
                            for t, kv in zip(args.tiers, args.kv_tiers)}
            except ValueError:
                ap.error(f"--kv-tiers values must be bf16, 8 or 4, got "
                         f"{args.kv_tiers}")
    else:
        if args.kv_tiers:
            ap.error("--kv-tiers needs --tiers")
        if args.serialize_tiers:
            ap.error("--serialize-tiers needs --tiers")
    if args.migrate_demo:
        if not args.tiers or len(args.tiers) < 2:
            ap.error("--migrate-demo needs --tiers with >= 2 tiers")
        if args.serialize_tiers:
            ap.error("--migrate-demo needs mixed-tier admission (drop "
                     "--serialize-tiers)")
    if args.slo and args.baseline:
        ap.error("--slo has no effect on the batch-at-a-time baseline")
    if (args.preempt or args.shed) and not args.slo:
        ap.error("--preempt/--shed are SLOPolicy overload hooks; they need "
                 "--slo")
    if args.spill_dir and not args.preempt:
        ap.error("--spill-dir only stores preempted-slot snapshots; it "
                 "needs --preempt")
    if args.auto_tier and not args.slo:
        ap.error("--auto-tier needs --slo (it is SLOPolicy's admission "
                 "hook)")
    if args.auto_tier and (not args.tiers or args.serialize_tiers):
        ap.error("--auto-tier needs runtime tiers with mixed admission "
                 "(--tiers, no --serialize-tiers)")
    if args.speculate:
        if not args.tiers:
            ap.error("--speculate drafts at a plane-prefix tier; it needs "
                     "--tiers")
        if args.serialize_tiers:
            ap.error("--speculate needs mixed-tier admission (drop "
                     "--serialize-tiers)")
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
    if args.temperature > 0.0 and args.baseline:
        ap.error("--temperature needs the continuous-batching engine; the "
                 "baseline decodes greedily (drop --baseline)")

    if schedule is not None:
        policy = schedule.policy_for()
    elif args.tiers:
        if args.backend == "dense":
            ap.error("--tiers needs an integer backend")
        schedule = uniform_schedule(
            {t: tuple(int(b) for b in t.split("/")) for t in args.tiers},
            backend=args.backend, kv_tiers=kv_tiers)
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
    # A reduced model serves its MoE layers dropless, as the reference's
    # command line does.
    rt = Runtime(policy=policy, moe_dropless=args.reduced, schedule=schedule)
    # The command line always serves with telemetry: the report at the end,
    # --metrics and --trace-out read it.
    tele = Telemetry(profile=args.profile)
    if args.baseline:
        engine = engine_mod.BatchServeEngine(
            model, params, rt, max_batch=args.max_batch,
            max_len=args.max_len, kv_bits=args.kv_bits, telemetry=tele,
            device=device)
    else:
        scheduler_policy = SLOPolicy(
            schedule, auto_tier=args.auto_tier,
            mac_counts=cfg.quant_layer_macs() if schedule else None,
            preempt=args.preempt,
            # A queued request may wait about two chunks before the
            # displacement check sees it again.
            preempt_slack=2.0 * args.decode_chunk, shed=args.shed) \
            if args.slo else None
        engine = engine_mod.ServeEngine(
            model, params, rt, max_batch=args.max_batch,
            max_len=args.max_len, kv_bits=args.kv_bits,
            decode_chunk=args.decode_chunk,
            mixed_tiers=not args.serialize_tiers,
            scheduler_policy=scheduler_policy, spill_dir=args.spill_dir,
            telemetry=tele, device=device)

    rng = np.random.default_rng(args.seed)
    tier_of = (lambda i: args.tiers[i % len(args.tiers)]) if args.tiers \
        else (lambda i: None)
    sampling = None
    if args.temperature > 0.0 or args.top_k > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, seed=args.seed)
    spec = SpecConfig(draft_tier=args.draft_tier, k=args.spec_k) \
        if args.speculate else None
    # --slo: every 3rd request is urgent (a tight budget in scheduler-clock
    # ticks), the rest patient.  With --preempt/--shed the stream is an
    # overload trace: the patient requests become long best-effort ones
    # (the victims: no slot frees within an urgent deadline on its own),
    # the urgent ones get deadlines of a few chunks and arrive once the
    # long ones hold every slot, and the last urgent one has a budget no
    # tier can serve in time (the shed case).
    overload = args.preempt or args.shed
    urgent_deadline = (2.5 * args.decode_chunk if overload
                       else 4.0 * args.max_new)
    urgent_ids = [i for i in range(args.requests) if i % 3 == 2]
    deadline_of = (lambda i: urgent_deadline if i % 3 == 2
                   else None if overload else 50.0 * args.max_new) \
        if args.slo else (lambda i: None)

    def budget_of(i: int) -> int:
        if not overload:
            return 1 + (args.max_new * (i % 4)) // 3
        if i % 3 == 2:
            return (3 * args.max_new if i == urgent_ids[-1]
                    else min(4, args.max_new))
        return 3 * args.max_new

    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=4 + i % 5).astype(np.int32),
                    max_new_tokens=budget_of(i),
                    tier=tier_of(i), deadline=deadline_of(i),
                    sampling=sampling, spec=spec)
            for i in range(args.requests)]
    t0 = time.time()
    urgent_tail = [r for r in reqs if r.deadline is not None
                   and r.deadline <= urgent_deadline] if overload else []
    held = {r.uid for r in urgent_tail}
    handles = [engine.submit(r) for r in reqs if r.uid not in held]
    events = 0
    migrated = None
    while engine.has_work or urgent_tail:
        events += len(engine.step())
        if urgent_tail and (engine.clock >= 2.0 * args.decode_chunk
                            or not engine.has_work):
            handles += [engine.submit(r) for r in urgent_tail]
            urgent_tail = []
        if args.migrate_demo and migrated is None:
            target = args.tiers[-1]
            for h in handles:
                if (h.status is RequestStatus.RUNNING and h.tier != target
                        and len(h.tokens) >= 2):
                    h.set_tier(target)
                    migrated = h
                    print(f"migrated uid={h.uid} -> {target} after "
                          f"{len(h.tokens)} tokens (clock "
                          f"{engine.clock:.0f})")
                    break
    dt = time.time() - t0
    if args.migrate_demo and migrated is None:
        print("migrate-demo: no request lived long enough to migrate — "
              "every budget fit one decode chunk; raise --max-new or "
              "lower --decode-chunk")
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
        "tier_switches": st.tier_switches,
        "tier_migrations": st.tier_migrations,
        "kv_migrations": st.kv_migrations,
        "tier_autoselects": st.tier_autoselects,
        "decode_steps_by_tier": st.decode_steps_by_tier,
        "tokens_by_tier": st.tokens_by_tier}, sort_keys=True))
    if args.slo:
        misses = [h.uid for h in handles if h.request.deadline is not None
                  and h.finished_at - h.submitted_at > h.request.deadline]
        print("slo " + json.dumps({
            "queue_wait": {h.uid: h.queue_wait for h in handles},
            "deadline_misses": misses,
            "tiers": {h.uid: h.tier for h in handles}}, sort_keys=True))
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
    print(serve_report(tele.registry, tiers=args.tiers,
                       mixed=not args.serialize_tiers, slo=args.slo,
                       speculate=args.speculate, overload=overload))
    if overload:
        shed_uids = [h.uid for h in handles
                     if h.status is RequestStatus.SHED]
        print(f"shed_uids={shed_uids}")
    if args.profile:
        assert tele.profiler is not None
        print("profile: " + json.dumps(tele.profiler.snapshot()["phases"],
                                       sort_keys=True))
    if args.metrics is not None:
        if args.metrics == "-":
            print(tele.prometheus(), end="")
        elif args.metrics.endswith(".json"):
            prof = tele.profiler.snapshot() if tele.profiler else None
            write_json(args.metrics, tele.registry, prof)
            print(f"metrics: wrote {args.metrics}")
        else:
            with open(args.metrics, "w") as fh:
                fh.write(tele.prometheus())
            print(f"metrics: wrote {args.metrics}")
    if args.trace_out:
        tele.write_trace(args.trace_out)
        print(f"trace: wrote {args.trace_out} "
              f"({len(tele.tracer.chrome_events())} events)")
    return results


if __name__ == "__main__":
    main()
