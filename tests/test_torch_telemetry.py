"""repro_torch.telemetry: the reference's telemetry tests ported
(``tests/test_telemetry.py``: histograms, the registry, the EngineStats
twins, the Prometheus round-trip and the trace schema), the same registry
rendered to the same Prometheus text by both packages, and the two engine
contracts on the port:

* zero cost when off — a ``telemetry=None`` engine takes no hook
  (``HOOK_CALLS`` does not move), makes no span call (the recorder slot
  stays empty and ``Tracer.begin`` / ``end`` raise) and makes no device
  sync (``torch.cuda.synchronize`` and ``torch.cuda.Event`` raise for the
  whole run), and neither does a non-profiling telemetry;
* identical tokens when on — with ``Telemetry(profile=True)`` the streams
  equal the telemetry-off run's, plain and speculative, and the EngineStats
  twins, histograms, profiler phases, spans and exports agree with the
  engine;
* the spans — with a recorder in the slot, on the reduced qwen3-8b and
  mamba2-1.3b: ``step`` holds ``admit`` (its prefills, each with its
  blocks and ``sync``), ``decode_chunk`` (its decode steps, each with its
  blocks and ``select``, and its ``sync``) and ``emit``; every span
  carries the fields the benchmark's readers take, lies inside the clock
  reads around its step, and the ``prefill`` / ``decode_chunk`` spans add
  up to ``EngineStats.prefill_seconds`` / ``decode_seconds`` exactly.

The engine tests run on the reduced qwen3-8b with seeded torch weights.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import repro.telemetry as jtelemetry
import repro_torch.telemetry as telemetry_mod
from repro.serve.engine import EngineStats as JEngineStats
from repro_torch.configs import reduced_config
from repro_torch.core.policy import uniform_schedule
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import (BatchServeEngine, Request, ServeEngine,
                               SpecConfig)
from repro_torch.serve.engine import EngineStats
from repro_torch.telemetry import (Histogram, MetricsRegistry, Telemetry,
                                   Tracer, format_group_layout,
                                   parse_prometheus, serve_report,
                                   sync_engine_stats, to_prometheus)
from repro_torch.telemetry import trace as tracing

TIERS = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}


@pytest.fixture(scope="module")
def setup():
    """The reduced model, its weights prepared once into the superplane
    store, and the runtime (kv_tiers: one mixed arena)."""
    model = LM(reduced_config("qwen3-8b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    sched = uniform_schedule(TIERS, backend="cuda", kv_tiers=KV_TIERS)
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    eng = ServeEngine(model, model.init(gen, device="cpu"), rt, device="cpu")
    return model, eng.params, rt


def _requests(n=6, seed=13, **extra):
    rng = np.random.default_rng(seed)
    names = list(TIERS)
    return [Request(uid=i, prompt=rng.integers(0, 512, size=3 + i % 4)
                    .astype(np.int32), max_new_tokens=5 + i % 3,
                    tier=names[i % 3], **extra)
            for i in range(n)]


# ------------------------------------------------------------- primitives
def test_histogram_quantiles_interpolate():
    h = Histogram("h", "", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 1.5, 3.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(6.5)
    assert h.mean() == pytest.approx(6.5 / 4)
    assert h.counts == [1, 2, 1, 0]
    assert h.quantile(0.0) == 0.0
    assert h.quantile(0.5) == pytest.approx(1.5)
    assert h.quantile(1.0) == pytest.approx(4.0)
    h.observe(100.0)                      # the overflow bucket degenerates
    assert h.quantile(1.0) == pytest.approx(4.0)
    assert Histogram("e", "").quantile(0.99) == 0.0


def test_histogram_rejects_bad_buckets():
    with pytest.raises(ValueError, match="ascending"):
        Histogram("h", "", buckets=(2.0, 1.0))
    with pytest.raises(ValueError, match="Inf"):
        Histogram("h", "", buckets=(1.0, float("inf")))
    with pytest.raises(ValueError, match="outside"):
        Histogram("h", "", buckets=(1.0,)).quantile(1.5)


def test_registry_idempotent_and_kind_clash():
    r = MetricsRegistry()
    c = r.counter("serve_x", "first")
    assert r.counter("serve_x", "second") is c
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("serve_x")
    c.inc(2.0)
    assert r.value("serve_x") == 2.0
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1.0)
    r.histogram("serve_h", "")
    with pytest.raises(TypeError, match="histogram"):
        r.value("serve_h")
    g = r.gauge("serve_by_tier", labels=("tier",))
    g.set(3.0, tier="4/4")
    assert r.value("serve_by_tier", tier="4/4") == 3.0
    assert r.value("serve_by_tier", tier="2/2") == 0.0
    with pytest.raises(ValueError, match="expected labels"):
        g.set(1.0, wrong="x")
    assert r.value("never_registered") == 0.0


def _fill(stats):
    stats.prefills = 3
    stats.decode_steps = 17
    stats.preemptions = 2
    stats.spill_bytes = 4096
    stats.decode_steps_by_tier["4/4"] = 9
    stats.tokens_by_tier["2/2"] = 5
    stats.decode_dispatches[(("8/8", 2), ("4/4", 1))] = 8
    return stats


def test_sync_engine_stats_twins():
    stats = _fill(EngineStats())
    r = MetricsRegistry()
    sync_engine_stats(r, stats)
    assert r.value("serve_prefills") == 3.0
    assert r.value("serve_decode_steps") == 17.0
    assert r.value("serve_preemptions") == 2.0
    assert r.value("serve_decode_steps_by_tier", tier="4/4") == 9.0
    assert r.value("serve_tokens_by_tier", tier="2/2") == 5.0
    assert r.value("serve_decode_dispatches", layout="8/8x2+4/4x1") == 8.0
    stats.decode_steps = 18               # re-sync: no double counting
    sync_engine_stats(r, stats)
    assert r.value("serve_decode_steps") == 18.0


def test_format_group_layout():
    assert format_group_layout((("8/8", 2), ("4/4", 1))) == "8/8x2+4/4x1"
    assert format_group_layout(()) == ""


# -------------------------------------------------------------- exporters
def test_prometheus_roundtrip_bit_exact():
    r = MetricsRegistry()
    r.counter("serve_total", "a\ncounter").inc(0.1 + 0.2)
    r.gauge("serve_ratio").set(1e-17)
    r.counter("serve_by_tier", labels=("tier",)).inc(
        3.0, tier='we"ird\\tier\n')
    h = r.histogram("serve_lat", "latency", buckets=(1.0, 8.0))
    for v in (0.5, 4.0, 99.0):
        h.observe(v)
    text = to_prometheus(r)
    assert "# TYPE serve_lat histogram" in text
    parsed = parse_prometheus(text)
    assert parsed["serve_total"][()] == 0.1 + 0.2          # bit-exact
    assert parsed["serve_ratio"][()] == 1e-17
    assert parsed["serve_by_tier"][(("tier", 'we"ird\\tier\n'),)] == 3.0
    buckets = parsed["serve_lat_bucket"]
    assert buckets[(("le", "1.0"),)] == 1.0
    assert buckets[(("le", "8.0"),)] == 2.0
    assert buckets[(("le", "+Inf"),)] == 3.0
    assert parsed["serve_lat_count"][()] == 3.0
    assert parsed["serve_lat_sum"][()] == 103.5
    with pytest.raises(ValueError, match="unparseable"):
        parse_prometheus("this is not a metric line")


def test_prometheus_text_equals_the_reference():
    """The same EngineStats values and observations render to the same
    Prometheus text in both packages (the dispatch gauge's help line
    names what each counts), and each parses the other's."""
    texts = []
    help_line = "# HELP serve_decode_dispatches"
    for mod, stats in ((telemetry_mod, EngineStats()),
                       (jtelemetry, JEngineStats())):
        r = mod.MetricsRegistry()
        mod.sync_engine_stats(r, _fill(stats))
        h = r.histogram("serve_q", "ticks", buckets=mod.TICK_BUCKETS)
        for v in (0.0, 3.0, 1e3, 0.1 + 0.2):
            h.observe(v)
        r.gauge("serve_util").set(2.0 / 3.0)
        texts.append([line for line in mod.to_prometheus(r).splitlines()
                      if not line.startswith(help_line)])
    assert texts[0] == texts[1]
    text = "\n".join(texts[0])
    assert parse_prometheus(text) == jtelemetry.parse_prometheus(text)


def test_tracer_schema_and_monotone_tracks(tmp_path):
    tr = Tracer()
    tr.request_phase(0, "queued", ticks=0.0)
    tr.request_phase(1, "queued", ticks=0.0)
    span = tr.begin("prefill", uid=0, ticks=0.0)
    tr.end(span, ticks_end=0.0)
    tr.request_phase(0, "running", ticks=0.0)
    chunk = tr.begin("decode_chunk", ticks=0.0, n_steps=4)
    tr.end(tr.begin("decode_step"))
    tr.end(chunk, ticks_end=4.0)
    tr.engine_instant("preempt", ticks=4.0, args={"uid": 0})
    tr.request_phase(0, "suspended", ticks=4.0)
    tr.request_end(0, "finished", ticks=8.0)
    tr.request_end(1, "shed", ticks=8.0)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert events
    for ev in events:
        assert {"name", "ph", "pid", "tid"} <= set(ev), ev
        assert ev["pid"] == 1 and ev["ph"] in ("X", "i", "M")
        if ev["ph"] != "M":
            assert "ts" in ev, ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] == "t"
    body = [ev for ev in events if ev["ph"] != "M"]
    by_track = {}
    for ev in body:
        by_track.setdefault(ev["tid"], []).append(ev["ts"])
    assert set(by_track) == {0, 1, 2}      # engine + one track per uid
    for tid, stamps in by_track.items():
        assert stamps == sorted(stamps), f"track {tid} ts not monotone"
    names = {(ev["tid"], ev["name"]) for ev in body}
    spans = {ev["name"]: ev for ev in body if ev["tid"] == 0
             and ev["ph"] == "X"}
    assert spans["decode_step"]["args"]["parent"] == \
        spans["decode_chunk"]["args"]["id"]
    assert spans["prefill"]["args"] == {"uid": 0, "ticks": 0.0,
                                        "ticks_end": 0.0, "parent": 0,
                                        "id": spans["prefill"]["args"]["id"]}
    for want in [(0, "prefill"), (0, "decode_chunk"), (0, "preempt"),
                 (1, "queued"), (1, "running"), (1, "suspended"),
                 (1, "finished"), (2, "queued"), (2, "shed")]:
        assert want in names, f"missing event {want}"


# ------------------------------------------------------ engine contracts
@pytest.mark.parametrize("telemetry", [None, "plain"])
def test_zero_cost_when_off(setup, monkeypatch, telemetry):
    """No hook and no span call without telemetry (the recorder slot
    empty), and no device sync by the engine without a profiling
    telemetry.  A telemetry's engine records into the telemetry's tracer
    for its own steps and leaves the slot as it found it."""
    model, params, rt = setup

    def forbidden(*a, **k):
        raise AssertionError("the engine synchronized with the device")

    def no_span(*a, **k):
        raise AssertionError("a span call with the recorder slot empty")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    tele = Telemetry() if telemetry else None
    if tele is None:
        monkeypatch.setattr(Tracer, "begin", no_span)
        monkeypatch.setattr(Tracer, "end", no_span)
    eng = ServeEngine(model, params, rt, max_batch=3, max_len=64,
                      decode_chunk=4, telemetry=tele, device="cpu")
    before = telemetry_mod.HOOK_CALLS
    assert tracing.CURRENT is None
    out = eng.run(_requests())
    assert tracing.CURRENT is None
    assert sum(len(v) for v in out.values()) > 0
    assert (telemetry_mod.HOOK_CALLS == before) == (tele is None)
    if tele is not None:
        names = {sp.name for sp in tele.tracer.spans}
        assert {"step", "prefill", "decode_chunk", "attn", "linear"} <= names


# The parent each span name may have.
PARENTS = {
    "step": {None}, "admit": {"step"}, "prefill": {"admit"},
    "decode_chunk": {"step"}, "emit": {"step"},
    "decode_step": {"decode_chunk"}, "sync": {"prefill", "decode_chunk"},
    "select": {"prefill", "decode_step"}, "embed": {"prefill", "decode_step"},
    "head": {"prefill", "decode_step"}, "attn": {"prefill", "decode_step"},
    "ssm": {"prefill", "decode_step"}, "mlp": {"prefill", "decode_step"},
    "rope": {"attn"}, "kv_write": {"attn"}, "attn_core": {"attn"},
    "ssm_core": {"ssm"}, "linear": {"attn", "ssm", "mlp", "head"}}
# The fields each span name carries (a counter is one).
FIELDS = {
    "step": {"tokens"},
    "prefill": {"tier", "prompt_len", "padded_len", "rows", "ticks",
                "ticks_end"},
    "decode_chunk": {"n_steps", "rows", "active_lanes", "layout", "ticks",
                     "ticks_end"},
    "decode_step": {"rows", "groups"}, "attn": {"layer"},
    "ssm": {"layer"}, "mlp": {"layer"}, "attn_core": {"launches"},
    "linear": {"name", "rows", "launches"}}


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b"])
def test_spans_nest_carry_fields_and_add_up(arch, monkeypatch):
    """With a recorder in the slot (as a benchmark fills it): the spans
    nest as the engine's blocks do, carry the fields the readers take,
    each lies inside the clock reads around its step, the prefill and
    decode-chunk spans add up to EngineStats' seconds exactly, and the
    streams equal an unrecorded run's."""
    model = LM(reduced_config(arch))
    gen = torch.Generator()
    gen.manual_seed(3)
    sched = uniform_schedule(TIERS, backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    kw = dict(max_batch=3, max_len=64, decode_chunk=4, device="cpu")
    off = ServeEngine(model, model.init(gen, device="cpu"), rt, **kw)
    want = off.run(_requests())
    eng = ServeEngine(model, off.params, rt, **kw)
    for r in _requests():
        eng.submit(r)
    rec = Tracer()
    monkeypatch.setattr(tracing, "CURRENT", rec)
    windows = []
    while eng.has_work:
        n, t0 = len(rec.spans), time.perf_counter()
        eng.step()
        windows.append((n, len(rec.spans), t0, time.perf_counter()))
    monkeypatch.setattr(tracing, "CURRENT", None)
    assert eng.results == want

    spans = rec.spans
    by_id = {sp.id: sp for sp in spans}
    assert len(by_id) == len(spans) and not rec._open
    kids = {}
    for sp in spans:
        parent = by_id[sp.parent].name if sp.parent else None
        assert parent in PARENTS[sp.name], (sp.name, parent)
        assert FIELDS.get(sp.name, set()) <= set(sp.args), sp.name
        kids.setdefault(sp.parent, []).append(sp)
        if sp.parent:
            outer = by_id[sp.parent]
            assert outer.start <= sp.start <= sp.end <= outer.end
    for n0, n1, t0, t1 in windows:
        for sp in spans[n0:n1]:
            assert t0 <= sp.start <= sp.end <= t1
        assert spans[n1 - 1].name == "step"
    names = [sp.name for sp in spans]
    assert names.count("step") == len(windows)
    assert names.count("prefill") == eng.stats.prefills == len(want)
    assert names.count("decode_chunk") == eng.stats.decode_chunks
    assert names.count("decode_step") == eng.stats.decode_steps
    mixer = "attn" if arch == "qwen3-8b" else "ssm"
    core = {"attn": {"rope", "kv_write", "attn_core"}, "ssm": {"ssm_core"}}
    layers = model.cfg.num_layers
    uids = set()
    for sp in spans:
        below = [c.name for c in kids.get(sp.id, [])]
        if sp.name == "decode_chunk":
            assert below.count("decode_step") == sp.args["n_steps"]
            assert below.count("sync") == 1
            assert sp.args["rows"] == 3 and sp.args["layout"]
            assert 0 < sp.args["active_lanes"] <= 3
            assert sp.args["ticks_end"] - sp.args["ticks"] == \
                sp.args["n_steps"]
        elif sp.name in ("decode_step", "prefill"):
            assert below.count(mixer) == layers
            assert below.count("embed") == below.count("head") == 1
            assert below.count("select") == 1
            assert below.count("sync") == (sp.name == "prefill")
            if sp.name == "decode_step":
                assert sp.args["rows"] == 3
                assert sum(n for _, n in sp.args["groups"]) == 3
            else:
                assert sp.args["rows"] == sp.args["padded_len"] \
                    >= sp.args["prompt_len"]
                uids.add(sp.uid)
                assert all(c.uid == sp.uid for c in kids[sp.id])
        elif sp.name == mixer:
            assert core[mixer] <= set(below) and "linear" in below
            assert 0 <= sp.args["layer"] < layers
        elif sp.name in ("linear", "attn_core"):
            assert sp.args["launches"] == 0          # the CPU launches none
            assert sp.name == "attn_core" \
                or sp.args["name"].endswith("_proj") \
                or sp.args["name"] == "lm_head"
    assert uids == set(want)
    assert sum(sp.end - sp.start for sp in spans
               if sp.name == "decode_chunk") == eng.stats.decode_seconds
    assert sum(sp.end - sp.start for sp in spans
               if sp.name == "prefill") == eng.stats.prefill_seconds
    assert sum(sp.args["tokens"] for sp in spans if sp.name == "step") == \
        sum(len(v) for v in want.values())


def test_token_identity_mixed_tiers(setup, tmp_path):
    """Profiled telemetry changes no token; the EngineStats twins agree,
    the latency histograms cover every request, the profiler counts every
    dispatch (on the CPU it records no device seconds), and the report and
    exports render from the same registry."""
    model, params, rt = setup
    got_off = ServeEngine(model, params, rt, max_batch=3, max_len=64,
                          decode_chunk=4, device="cpu").run(_requests())
    tele = Telemetry(profile=True)
    on = ServeEngine(model, params, rt, max_batch=3, max_len=64,
                     decode_chunk=4, telemetry=tele, device="cpu")
    assert on.run(_requests()) == got_off
    reg = tele.registry
    for f in dataclasses.fields(on.stats):
        v = getattr(on.stats, f.name)
        if isinstance(v, int):
            assert reg.value("serve_" + f.name) == float(v), f.name
    for tier, n in on.stats.decode_steps_by_tier.items():
        assert reg.value("serve_decode_steps_by_tier", tier=tier) == float(n)
    n = len(got_off)
    for name in ("serve_queue_wait_ticks", "serve_ttft_ticks",
                 "serve_tpot_ticks", "serve_ttft_seconds"):
        assert reg.get(name).count == n, name
    assert 0.0 < reg.value("serve_slot_utilization") <= 1.0
    assert 0.0 < reg.value("serve_modeled_cycle_utilization") <= 1.0
    prof = tele.profiler.snapshot()
    assert prof["phases"]["prefill"]["calls"] == on.stats.prefills
    assert prof["phases"]["decode_chunk"]["calls"] == on.stats.decode_chunks
    assert prof["phases"]["decode_chunk"]["total_s"] > 0.0
    assert "device_s" not in prof["phases"]["decode_chunk"]
    # A profiling engine counts each layout's kernel launches: none here.
    assert prof["decode_dispatches"] and \
        set(prof["decode_dispatches"].values()) == {0}
    report = serve_report(reg, tiers=list(TIERS), overload=True)
    assert "slot_util=" in report and "preemptions=0" in report
    parsed = parse_prometheus(tele.prometheus())
    assert parsed["serve_decode_steps"][()] == float(on.stats.decode_steps)
    path = tmp_path / "trace.json"
    tele.write_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert {ev["tid"] for ev in events if ev["ph"] != "M"} == \
        {0} | {uid + 1 for uid in got_off}
    snap = tele.snapshot()
    assert snap["metrics"]["serve_ttft_ticks"]["count"] == n
    assert snap["profile"]["phases"]["prefill"]["calls"] == on.stats.prefills
    # Each dispatch recorded once, by the engine's own span.
    spans = [ev for ev in events if ev["ph"] == "X" and ev["tid"] == 0]
    assert sum(ev["name"] == "prefill" for ev in spans) == on.stats.prefills
    assert sum(ev["name"] == "decode_chunk" for ev in spans) == \
        on.stats.decode_chunks
    assert {ev["cat"] for ev in spans} == {"dispatch", "host"}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama4-scout-17b-a16e"])
def test_token_identity_hybrid_and_moe_archs(arch):
    """Hybrid and MoE stacks: profiled telemetry changes no token, its
    tier pricing reads the SSM and MoE layers' MACs, and the profiler
    counts each layout's kernel launches (none on the CPU)."""
    model = LM(reduced_config(arch))
    gen = torch.Generator()
    gen.manual_seed(2)
    sched = uniform_schedule(TIERS, backend="cuda", kv_tiers=KV_TIERS)
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    kw = dict(max_batch=3, max_len=64, decode_chunk=4, device="cpu")
    off = ServeEngine(model, model.init(gen, device="cpu"), rt, **kw)
    want = off.run(_requests(5))
    tele = Telemetry(profile=True)
    on = ServeEngine(model, off.params, rt, telemetry=tele, **kw)
    assert on.run(_requests(5)) == want
    assert 0.0 < tele.registry.value("serve_modeled_cycle_utilization") <= 1.0
    names = {sp.name for sp in tele.tracer.spans}
    assert ({"ssm", "ssm_core", "moe"} if arch.startswith("jamba")
            else {"attn", "moe"}) <= names
    prof = tele.profiler.snapshot()
    assert set(prof["decode_dispatches"].values()) == {0}


def test_token_identity_speculative(setup):
    """Through speculative rounds: the same tokens, the spec counters
    mirrored and the acceptance gauge consistent."""
    model, params, rt = setup
    reqs = dict(n=4, seed=7, spec=SpecConfig(draft_tier="2/2", k=2))
    kw = dict(max_batch=2, max_len=64, decode_chunk=2, device="cpu")
    got_off = ServeEngine(model, params, rt, **kw).run(_requests(**reqs))
    tele = Telemetry(profile=True)
    on = ServeEngine(model, params, rt, telemetry=tele, **kw)
    assert on.run(_requests(**reqs)) == got_off
    assert on.stats.spec_rounds > 0
    reg = tele.registry
    assert reg.value("serve_spec_rounds") == float(on.stats.spec_rounds)
    assert reg.value("serve_spec_accepted") == float(on.stats.spec_accepted)
    assert reg.value("serve_spec_acceptance_rate") == pytest.approx(
        on.stats.spec_accepted / on.stats.spec_drafted)
    assert tele.profiler.snapshot()["phases"]["spec_round"]["calls"] == \
        on.stats.spec_rounds
    # The round's one span is the parent of its blocks.
    rounds = {sp.id: sp for sp in tele.tracer.spans
              if sp.name == "spec_round"}
    assert len(rounds) == on.stats.spec_rounds
    assert all(sp.args["k"] == 2 for sp in rounds.values())
    assert sum(sp.end - sp.start for sp in tele.tracer.spans
               if sp.name in ("spec_round", "decode_chunk")) == \
        on.stats.decode_seconds
    under = {sp.name for sp in tele.tracer.spans if sp.parent in rounds}
    assert {"embed", "attn", "mlp", "head"} <= under
    assert "speculate: rounds=" in serve_report(reg, speculate=True)


def test_deadline_miss_counter(setup):
    """An impossible deadline counts once, a generous one does not."""
    model, params, rt = setup
    tele = Telemetry()
    eng = ServeEngine(model, params, rt, max_batch=2, max_len=64,
                      decode_chunk=4, telemetry=tele, device="cpu")
    reqs = _requests(n=2)
    reqs[0].deadline = 0.5
    reqs[1].deadline = 1e6
    eng.run(reqs)
    assert tele.registry.value("serve_deadline_misses") == 1.0


def test_batch_engine_with_telemetry(setup):
    """BatchServeEngine's hooks: the same tokens, a prefill and a decode
    span per step, the twins in sync."""
    model, params, rt = setup
    reqs = [dataclasses.replace(r, tier=None) for r in _requests(n=4)]
    got_off = BatchServeEngine(model, params, rt, max_batch=2, max_len=64,
                               tier="4/4", device="cpu").run(reqs)
    tele = Telemetry(profile=True)
    on = BatchServeEngine(model, params, rt, max_batch=2, max_len=64,
                          tier="4/4", telemetry=tele, device="cpu")
    assert on.run(reqs) == got_off
    prof = tele.profiler.snapshot()["phases"]
    assert prof["prefill"]["calls"] == 2
    assert prof["decode_chunk"]["calls"] == on.stats.decode_steps
    names = [sp.name for sp in tele.tracer.spans]
    assert names.count("prefill") == 2
    assert names.count("decode_chunk") == on.stats.decode_steps
    assert sum(sp.end - sp.start for sp in tele.tracer.spans
               if sp.name == "decode_chunk") == on.stats.decode_seconds
    assert tele.registry.value("serve_decode_steps") == \
        float(on.stats.decode_steps)
    assert tele.registry.get("serve_ttft_ticks").count == len(reqs)
