"""repro_torch.telemetry: the reference's telemetry tests ported
(``tests/test_telemetry.py``: histograms, the registry, the EngineStats
twins, the Prometheus round-trip and the trace schema), the same registry
rendered to the same Prometheus text by both packages, and the two engine
contracts on the port:

* zero cost when off — a ``telemetry=None`` engine takes no hook
  (``HOOK_CALLS`` does not move) and makes no device sync
  (``torch.cuda.synchronize`` and ``torch.cuda.Event`` raise for the whole
  run), and neither does a non-profiling telemetry;
* identical tokens when on — with ``Telemetry(profile=True)`` the streams
  equal the telemetry-off run's, plain and speculative, and the EngineStats
  twins, histograms, profiler phases and exports agree with the engine.

The engine tests run on the reduced qwen3-8b with seeded torch weights.
"""
import dataclasses
import json

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
    t0 = tr.now()
    tr.dispatch("prefill", t0, ticks=0.0, ticks_end=0.0, args={"uid": 0})
    tr.request_phase(0, "running", ticks=0.0)
    tr.dispatch("decode_chunk", tr.now(), ticks=0.0, ticks_end=4.0,
                args={"n_steps": 4})
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
    for want in [(0, "prefill"), (0, "decode_chunk"), (0, "preempt"),
                 (1, "queued"), (1, "running"), (1, "suspended"),
                 (1, "finished"), (2, "queued"), (2, "shed")]:
        assert want in names, f"missing event {want}"


# ------------------------------------------------------ engine contracts
@pytest.mark.parametrize("telemetry", [None, "plain"])
def test_zero_cost_when_off(setup, monkeypatch, telemetry):
    """No hook without telemetry, and no device sync by the engine without
    a profiling telemetry."""
    model, params, rt = setup

    def forbidden(*a, **k):
        raise AssertionError("the engine synchronized with the device")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    tele = Telemetry() if telemetry else None
    eng = ServeEngine(model, params, rt, max_batch=3, max_len=64,
                      decode_chunk=4, telemetry=tele, device="cpu")
    before = telemetry_mod.HOOK_CALLS
    out = eng.run(_requests())
    assert sum(len(v) for v in out.values()) > 0
    assert (telemetry_mod.HOOK_CALLS == before) == (tele is None)


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
    assert tele.registry.value("serve_decode_steps") == \
        float(on.stats.decode_steps)
    assert tele.registry.get("serve_ttft_ticks").count == len(reqs)
