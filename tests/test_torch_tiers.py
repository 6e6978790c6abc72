"""repro_torch per-request KV precision tiers and the serving modes built on
them, held against the JAX package's ServeEngine and re-asserted within the
port, on the reduced qwen3-8b with tiers 8/8 4/4 2/2 and ``kv_tiers``
{8/8: bf16, 4/4: 8, 2/2: 4} (one mixed byte-lane KV arena).

Greedy streams must EQUAL the reference engine's: one run on the mixed
arena in which three of the nine requests migrate mid-stream (the six
others, and the migrated ones up to their move, also give the streams of a
run without migration: a request's tokens do not depend on its batch).
The reference runs once, in one subprocess for the module
(``XLA_FLAGS=--xla_allow_excess_precision=false``, see
_torch_reference.py).  Within the port: the mixed run equals fixed-tier
``BatchServeEngine`` runs, natively prepared engines, the tier-serialized
mode and speculative decoding on the same arena; migrated lanes equal
``requantize`` on a copy.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_reference import (ENGINE_KW, ROOT, TIERS, reference_weights,
                              request_specs, to_requests)
from repro.core.policy import LayerPrecision as JLayerPrecision
from repro.core.policy import PrecisionSchedule as JPrecisionSchedule
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.hwmodel import energy as jenergy
from repro.serve import scheduler as jscheduler
from repro.serve.request import Request as JRequest
from repro_torch.configs import reduced_config
from repro_torch.core.policy import (LayerPrecision, PrecisionSchedule,
                                     uniform_policy, uniform_schedule)
from repro_torch.hwmodel import energy
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import KVCache, Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.engine import BatchServeEngine, Engine, ServeEngine
from repro_torch.serve.handle import RequestStatus
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import ANY_TIER, Scheduler, SLOPolicy
from repro_torch.spec import SamplingParams

KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}
# (uid, new tier, after this many tokens): uid 6 (8/8, bf16 KV) to int4,
# uid 1 (4/4, int8) to bf16, uid 2 (2/2, int4) to int8.
MIGRATIONS = [[6, "2/2", 3], [1, "8/8", 4], [2, "4/4", 5]]
MIGRATE_KW = dict(ENGINE_KW, decode_chunk=3)

# The reference engine over a list of runs (a fresh engine each): a run
# sets its engine keywords, its kv_tiers, its requests, and optionally
# migrations, applied after every step to each RUNNING request that has
# emitted enough tokens.  Prints each run's streams and a checksum of the
# weights it served.
REFERENCE = r"""
import hashlib, json, sys
import jax, numpy as np
from repro.configs import reduced_config
from repro.core.policy import uniform_schedule
from repro.models.layers import Runtime
from repro.models.transformer import LM
from repro.serve.engine import Request, ServeEngine
from repro.serve.handle import RequestStatus
from repro.spec import SpecConfig
spec = json.loads(sys.argv[1])
model = LM(reduced_config("qwen3-8b"))
params = model.init(jax.random.PRNGKey(0))
h = hashlib.sha1()
for leaf in jax.tree.leaves(params):
    h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
runs = []
for run in spec["runs"]:
    sched = uniform_schedule({t: tuple(b) for t, b in spec["tiers"].items()},
                             backend="decomposed", kv_tiers=run["kv_tiers"])
    rt = Runtime(policy=sched.policy_for(), mode="serve", schedule=sched)
    eng = ServeEngine(model, params, rt, **run["engine"])
    handles = {r["uid"]: eng.submit(Request(
        uid=r["uid"], prompt=np.asarray(r["prompt"], np.int32),
        max_new_tokens=r["max_new"], tier=r["tier"],
        spec=SpecConfig(*r["spec"]) if r.get("spec") else None))
        for r in run["requests"]}
    pending = list(run.get("migrate", []))
    while eng.has_work:
        eng.step()
        for m in list(pending):
            hd = handles[m[0]]
            if hd.status is RequestStatus.RUNNING and len(hd.tokens) >= m[2]:
                hd.set_tier(m[1])
                pending.remove(m)
    assert not pending, pending
    runs.append({"streams": {str(u): hd.tokens for u, hd in handles.items()},
                 "kv_migrations": eng.stats.kv_migrations})
print(json.dumps({"checksum": h.hexdigest(), "runs": runs}))
"""


def _reference(runs) -> subprocess.Popen:
    """Starts the reference engine on ``runs``; :func:`_result` reads it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    arg = json.dumps({"tiers": TIERS, "runs": runs})
    return subprocess.Popen([sys.executable, "-c", REFERENCE, arg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc: subprocess.Popen):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _spec_requests():
    return [dict(s, spec=["2/2", 3]) for s in request_specs()]


@pytest.fixture(scope="module")
def setup():
    """The reference engine's run with migrations (one subprocess), the
    same weights converted into the port, and the port's run of the same
    requests without migration (``plain``)."""
    proc = _reference([{"engine": MIGRATE_KW, "kv_tiers": KV_TIERS,
                        "requests": request_specs(), "migrate": MIGRATIONS}])
    _, _, mine, params = reference_weights()      # while the reference runs
    ref = _result(proc)
    assert mine == ref["checksum"]
    run = ref["runs"][0]
    out = {"model": LM(reduced_config("qwen3-8b")), "params": params,
           "migrated": {int(k): v for k, v in run["streams"].items()},
           "kv_migrations": run["kv_migrations"]}
    out["plain"] = _engine(out).run(to_requests(request_specs()))
    return out


def _rt(backend="cuda", kv_tiers=KV_TIERS):
    sched = uniform_schedule(TIERS, backend=backend, kv_tiers=kv_tiers)
    return Runtime(policy=sched.policy_for(), schedule=sched)


def _engine(setup, backend="cuda", params=None, **kw):
    return ServeEngine(setup["model"], params or setup["params"], _rt(backend),
                       device="cpu", **{**ENGINE_KW, **kw})


def _migrate_after(engine, handles, migrations):
    """Step ``engine`` to idle, applying ``migrations`` as the reference
    run does (after each step, to RUNNING requests with enough tokens)."""
    pending = [list(m) for m in migrations]
    while engine.has_work:
        engine.step()
        for m in list(pending):
            h = handles[m[0]]
            if h.status is RequestStatus.RUNNING and len(h.tokens) >= m[2]:
                h.set_tier(m[1])
                pending.remove(m)
    assert not pending
    return {uid: h.tokens for uid, h in handles.items()}


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_streams_equal_reference_engine(setup, backend):
    """Without migration: the requests the reference run left at their
    tier equal it whole, the migrated ones up to their move."""
    eng = _engine(setup, backend)
    out = eng.run(to_requests(request_specs()))
    assert out == setup["plain"]
    moved = {uid: after for uid, _, after in MIGRATIONS}
    for uid, toks in setup["migrated"].items():
        n = moved.get(uid, len(toks))
        assert out[uid][:n] == toks[:n], uid
    assert eng.stats.mixed_tier_chunks > 0
    modes = {c.modes for layer in eng.arena.caches for c in layer.values()}
    assert modes == {(16, 8, 4)}


def test_mixed_equals_batch_engines_and_native(setup):
    """THE invariant: one decode batch holding weight AND KV tiers gives
    each request the tokens of (a) a fixed-tier BatchServeEngine on the
    same store, its KV at the tier's precision, and (b) an engine prepared
    natively at the tier's precision with a homogeneous KV cache; no
    weight is prepared after construction."""
    model, ref = setup["model"], setup["plain"]
    specs = request_specs()
    eng = _engine(setup)
    calls = engine_mod.PREPARE_CALLS
    assert eng.run(to_requests(specs)) == ref
    for tier, (w, a) in TIERS.items():
        mine = [s for s in specs if s["tier"] == tier]
        want = {s["uid"]: ref[s["uid"]] for s in mine}
        base = BatchServeEngine(model, eng.params, _rt(), max_batch=4,
                                max_len=64, tier=tier, device="cpu")
        assert base.kv_bits == KV_TIERS[tier]
        assert base.run(to_requests(mine)) == want, tier
        native = ServeEngine(model, setup["params"],
                             Runtime(policy=uniform_policy(w, a, "cuda")),
                             kv_bits=KV_TIERS[tier], device="cpu", **ENGINE_KW)
        assert native.run(to_requests(mine, tiered=False)) == want, tier
    assert engine_mod.PREPARE_CALLS == calls + 3      # the native stores


def test_slot_reuse_across_kv_tiers(setup):
    """One slot serves bf16, int4, int8 and int4 requests back to back: its
    tier code is reset and set at each admission, and each output equals a
    fixed-tier BatchServeEngine's."""
    specs = [dict(s, tier=t) for s, t in zip(request_specs()[:4],
                                             ("8/8", "2/2", "4/4", "2/2"))]
    eng = _engine(setup, max_batch=1, decode_chunk=2)
    got = eng.run(to_requests(specs))
    assert eng.arena.tiers == [None] and eng.stats.prefills == 4
    assert {int(c.kv_bits[0]) for layer in eng.arena.caches
            for c in layer.values()} == {4}
    for tier in ("8/8", "2/2", "4/4"):
        mine = [s for s in specs if s["tier"] == tier]
        base = BatchServeEngine(setup["model"], eng.params, _rt(),
                                max_batch=1, max_len=64, tier=tier,
                                device="cpu")
        assert base.run(to_requests(mine)) == {s["uid"]: got[s["uid"]]
                                               for s in mine}, tier


def test_serialized_equals_mixed(setup):
    ser = _engine(setup, mixed_tiers=False)
    assert ser.run(to_requests(request_specs())) == setup["plain"]
    assert ser.stats.mixed_tier_chunks == 0 and ser.stats.tier_switches > 0
    assert ser.stats.decode_steps_by_tier.keys() == set(TIERS)
    mixed = _engine(setup)
    mixed.run(to_requests(request_specs()))
    assert mixed.stats.tier_switches == 0


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_migration_streams_equal_reference_engine(setup, backend):
    eng = _engine(setup, backend, **MIGRATE_KW)
    handles = {r.uid: eng.submit(r) for r in to_requests(request_specs())}
    assert _migrate_after(eng, handles, MIGRATIONS) == setup["migrated"]
    assert eng.stats.tier_migrations == eng.stats.kv_migrations == 3 \
        == setup["kv_migrations"]
    for uid, tier, after in MIGRATIONS:
        ev = handles[uid].events
        assert {e.tier for e in ev[:after]} == {request_specs()[uid]["tier"]}
        assert {e.tier for e in ev[after + MIGRATE_KW["decode_chunk"]:]} \
            <= {tier}


def _clone(caches):
    return [{p: KVCache(*[None if t is None else t.clone() for t in (
        c.k, c.v, c.k_scale, c.v_scale, c.length, c.kv_bits)], modes=c.modes)
        for p, c in layer.items()} for layer in caches]


def _tensors(caches):
    return [t for layer in caches for c in layer.values() for t in c.tensors()]


# After the first round: uid 0 (8/8, bf16 KV) to int4, uid 1 (4/4, int8)
# to bf16.
LIVE_MIGRATIONS = ((0, "2/2"), (1, "8/8"))


def test_migration_lanes_and_continuation(setup):
    """After one round, uid 0 moves bf16 -> int4 and uid 1 int8 -> bf16:
    the arena equals ``migrate_kv_tier`` on a copy taken before (every
    other slot and every length untouched), and a fresh engine that takes
    that copy as its arena after the same round continues identically."""
    specs = [dict(s, max_new=12) for s in request_specs()]

    def first_round():
        eng = _engine(setup, **MIGRATE_KW)
        hs = {r.uid: eng.submit(r) for r in to_requests(specs)}
        eng.step()
        return eng, hs
    eng, hs = first_round()
    before = _clone(eng.arena.caches)
    expect = _clone(eng.arena.caches)
    for uid, tier in LIVE_MIGRATIONS:
        hs[uid].set_tier(tier)
        slots_lib.migrate_kv_tier(expect, hs[uid].slot,
                                  eng.schedule.kv_code_for(tier))
    assert eng.stats.kv_migrations == 2
    for got, want, old in zip(_tensors(eng.arena.caches), _tensors(expect),
                              _tensors(before)):
        assert torch.equal(got, want)
        if got.ndim > 1:
            moved = [hs[u].slot for u, _ in LIVE_MIGRATIONS]
            keep = [s for s in range(got.shape[0]) if s not in moved]
            assert torch.equal(got[keep], old[keep])
        elif got.dtype == torch.int32 and got.shape[0] and \
                not torch.equal(got, old):      # only tier codes may move
            assert any(c.kv_bits is got for layer in eng.arena.caches
                       for c in layer.values())
    out = eng.drain()
    fresh, fh = first_round()
    for dst, src in zip(_tensors(fresh.arena.caches), _tensors(expect)):
        dst.copy_(src)
    for uid, tier in LIVE_MIGRATIONS:
        fh[uid].request.tier = tier
        fresh.arena.tiers[fh[uid].slot] = tier
    assert fresh.drain() == out


def test_same_kv_code_migrates_no_lane(setup):
    """Tiers sharing a KV code: a RUNNING request moves its weight prefix
    only; the arena stays byte for byte.  A QUEUED request is re-tagged
    and prefills at its new tier."""
    shared = {"8/8": 8, "4/4": 8, "2/2": 4}
    eng = ServeEngine(setup["model"], setup["params"],
                      _rt(kv_tiers=shared), device="cpu", **MIGRATE_KW)
    hs = {r.uid: eng.submit(r) for r in to_requests(
        [dict(s, max_new=12) for s in request_specs()])}
    eng.step()
    before = _clone(eng.arena.caches)
    hs[0].set_tier("4/4")
    assert eng.stats.tier_migrations == 1 and eng.stats.kv_migrations == 0
    assert all(torch.equal(a, b) for a, b in zip(_tensors(eng.arena.caches),
                                                 _tensors(before)))
    assert eng.arena.tiers[hs[0].slot] == "4/4" and hs[0].tier == "4/4"
    queued = next(h for h in hs.values() if h.status is RequestStatus.QUEUED)
    queued.set_tier("2/2")
    assert eng.stats.tier_migrations == 1
    eng.drain()
    assert queued.events[0].tier == "2/2"


def test_set_tier_and_cancel_errors(setup):
    eng = _engine(setup, decode_chunk=2)
    hs = [eng.submit(r) for r in to_requests(request_specs()[:5])]
    with pytest.raises(ValueError, match="unknown tier"):
        hs[0].set_tier("3/3")
    eng.step()
    with pytest.raises(RuntimeError, match="only QUEUED"):
        eng.cancel(hs[2].uid)
    eng.cancel(hs[4].uid)
    assert hs[4].status is RequestStatus.SHED and eng.stats.sheds == 1
    with pytest.raises(RuntimeError, match="already shed"):
        eng.cancel(hs[4].uid)
    eng.drain()
    with pytest.raises(RuntimeError, match="already finished"):
        hs[0].set_tier("2/2")
    with pytest.raises(KeyError):
        eng.cancel(99)
    ser = _engine(setup, mixed_tiers=False, decode_chunk=2)
    h = ser.submit(to_requests(request_specs()[2:3])[0])
    ser.step()
    with pytest.raises(RuntimeError, match="mixed_tiers=True"):
        h.set_tier("8/8")
    with pytest.raises(ValueError, match="mixed_tiers=True"):
        ser.submit(to_requests(_spec_requests()[1:2])[0])
    with pytest.raises(ValueError, match="kv_bits conflicts"):
        _engine(setup, kv_bits=8)


def test_greedy_speculation_on_the_mixed_arena(setup):
    """Drafts at the 2/2 prefix write KV at each slot's own code; the
    verify rewrites those lanes: spec streams equal plain decoding's, which
    equal the reference engine's."""
    eng = _engine(setup)
    assert eng.run(to_requests(_spec_requests())) == setup["plain"]
    assert eng.stats.spec_rounds > 0


def _jschedule(s: PrecisionSchedule) -> JPrecisionSchedule:
    def j(p: LayerPrecision) -> JLayerPrecision:
        return JLayerPrecision(p.w_bits, p.a_bits, p.w_signed, p.a_signed,
                               "pallas" if p.backend == "cuda" else p.backend)
    return JPrecisionSchedule(
        tiers={t: j(p) for t, p in s.tiers.items()},
        rules={t: {g: j(p) for g, p in r.items()} for t, r in s.rules.items()},
        default_tier=s.default_tier, kv_tiers=s.kv_tiers)


def test_tier_pricing_matches_the_reference():
    """``relative_tier_costs``, ``tier_cycles_per_token`` and
    ``fastest_tier`` of uniform and rule-refined schedules, with and
    without MAC counts, equal the reference's."""
    ruled = PrecisionSchedule(
        tiers={"hi": LayerPrecision(8, 8, backend="cuda"),
               "lo": LayerPrecision(8, 8, backend="cuda"),
               "mid": LayerPrecision(6, 6, backend="cuda")},
        rules={"lo": {"*.mlp.*": LayerPrecision(2, 4, backend="cuda")}})
    macs = reduced_config("qwen3-8b").quant_layer_macs()
    for s in (uniform_schedule(TIERS, kv_tiers=KV_TIERS), ruled):
        js = _jschedule(s)
        for m in (None, macs):
            assert energy.relative_tier_costs(s, m) == \
                jenergy.relative_tier_costs(js, m)
            assert energy.tier_cycles_per_token(s, m) == \
                jenergy.tier_cycles_per_token(js, m)
            assert energy.fastest_tier(s, m) == jenergy.fastest_tier(js, m)
    from repro.configs import reduced_config as jreduced
    assert macs == jreduced("qwen3-8b").quant_layer_macs()


def test_slo_policy_matches_the_reference():
    """Selection order (slack, then age, then queue position) and
    ``select_tier`` equal the reference SLOPolicy's on random queues."""
    rng = np.random.default_rng(7)
    sched = uniform_schedule(TIERS)
    mine, ref = SLOPolicy(sched, auto_tier=True), jscheduler.SLOPolicy(
        juniform_schedule(TIERS), auto_tier=True)
    assert mine.tier_costs == ref.tier_costs
    for _ in range(200):
        n = int(rng.integers(1, 7))
        reqs = [dict(uid=i, max_new_tokens=int(rng.integers(1, 20)),
                     tier=list(TIERS)[int(rng.integers(0, 3))],
                     deadline=None if rng.random() < 0.3
                     else float(rng.integers(1, 200)))
                for i in range(n)]
        sub = {i: float(rng.integers(0, 50)) for i in range(n)}
        now = float(rng.integers(50, 100))
        cand = [Request(prompt=np.ones(2, np.int32), **r) for r in reqs]
        jcand = [JRequest(prompt=np.ones(2, np.int32), **r) for r in reqs]
        assert mine.select(cand, sub, now) == ref.select(jcand, sub, now)
        for c, jc in zip(cand, jcand):
            assert mine.slack(c, sub, now) == ref.slack(jc, sub, now)
            assert mine.select_tier(c, sub[c.uid], now) == \
                ref.select_tier(jc, sub[c.uid], now)
    # The overload options are served (tests/test_torch_overload.py) and
    # validated as the reference validates them.
    assert SLOPolicy(sched, preempt=True).preempt
    with pytest.raises(ValueError, match="time_slice"):
        SLOPolicy(sched, time_slice=0)


def test_scheduler_tier_filter():
    """``peek`` and ``admit`` with a tier take that tier's oldest request;
    other tiers keep their queue position; ``cancel`` drops a waiting one."""
    s = Scheduler(1)
    for i, t in enumerate(("4/4", "8/8", "4/4")):
        s.submit(Request(uid=i, prompt=np.ones(2, np.int32), tier=t), now=i)
    assert s.peek().uid == 0 and s.peek(tier="8/8").uid == 1
    assert s.peek(tier="2/2") is None and len(s.waiting) == 3
    assert s.admit(0, tier="8/8").uid == 1
    s.release(0)
    assert s.admit(0, tier=ANY_TIER).uid == 0
    s.cancel(2)
    s.cancel(2)
    assert list(s.submitted_at) == [] and not s.waiting


def test_auto_tier_retags_at_admission(setup):
    """``SLOPolicy(auto_tier=True)``: a deadlined 8/8 request whose priced
    service (12 tokens at 16 a token) misses its deadline of 50 is retagged
    at admission to the best tier that fits (4/4: 12 x 4); its prefill,
    weight prefix and KV code follow (int8 lanes in its slot).  Best-effort requests keep their tier."""
    sched = _rt().schedule
    eng = ServeEngine(setup["model"], setup["params"], _rt(),
                      scheduler_policy=SLOPolicy(sched, auto_tier=True),
                      device="cpu", **ENGINE_KW)
    tight = Request(uid=0, prompt=np.ones(5, np.int32), max_new_tokens=12,
                    tier="8/8", deadline=50.0)
    loose = Request(uid=1, prompt=np.ones(5, np.int32), max_new_tokens=12,
                    tier="8/8")
    h0, h1 = eng.submit(tight), eng.submit(loose)
    eng.step()
    assert h0.tier == "4/4" and h1.tier == "8/8"
    assert eng.stats.tier_autoselects == 1
    assert h0.events[0].tier == "4/4"
    assert {int(c.kv_bits[h0.slot]) for layer in eng.arena.caches
            for c in layer.values()} == {8}
    eng.drain()
    assert tight.tier == "8/8"          # the caller's object is untouched


def test_engine_protocol_and_retire(setup):
    eng = _engine(setup)
    base = BatchServeEngine(setup["model"], setup["params"], _rt(),
                            max_batch=2, max_len=64, tier="4/4", device="cpu")
    for e in (eng, base):
        assert isinstance(e, Engine)
        hs = [e.submit(r) for r in to_requests(request_specs()[:3])]
        e.cancel(hs[2].uid)
        assert hs[2].status is RequestStatus.SHED and e.stats.sheds == 1
        e.drain()
        assert e.retire(hs[0].uid) == hs[0].tokens
        assert e.retire(hs[2].uid) == []
        assert hs[0].uid not in e.handles
        e.submit(to_requests(request_specs()[:1])[0])   # the uid is free
    with pytest.raises(RuntimeError, match="pins one tier"):
        base.handles[0].set_tier("8/8")
    with pytest.raises(ValueError, match="temperature sampling"):
        base.submit(dataclasses.replace(to_requests(request_specs()[5:6])[0],
                                        sampling=SamplingParams(0.5)))


@pytest.mark.parametrize("argv,error", [
    (["--kv-tiers", "bf16", "8"], "--kv-tiers needs --tiers"),
    (["--tiers", "8/8", "4/4", "--kv-tiers", "bf16"], "align 1:1"),
    (["--tiers", "8/8", "--kv-tiers", "x"], "bf16, 8 or 4"),
    (["--tiers", "8/8", "--baseline"], "--baseline has no"),
    (["--serialize-tiers"], "--serialize-tiers needs --tiers"),
    (["--tiers", "8/8", "4/4", "--serialize-tiers", "--migrate-demo"],
     "mixed-tier admission"),
    (["--auto-tier"], "--auto-tier needs --slo"),
    (["--slo", "--baseline"], "no effect on the batch")])
def test_serve_cli_errors(argv, error, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--reduced", "--device", "cpu"] + argv)
    assert error in capsys.readouterr().err
