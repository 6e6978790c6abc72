"""repro_torch ServeEngine held against the JAX package's ServeEngine, and
the reference's serving invariants re-asserted within the port.

Greedy streams must EQUAL the reference engine's on the same requests and
converted weights (reduced qwen3-8b, tiers 8/8 4/4 2/2, max_batch 4).  The
reference engine runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (see _torch_reference.py).
"""
import numpy as np
import pytest
import torch

from _torch_reference import (ENGINE_KW, TIERS, reference_streams,
                              reference_weights, request_specs, to_requests)
from repro_torch.configs import reduced_config
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.handle import RequestStatus
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.spec import SamplingParams, SpecConfig


@pytest.fixture(scope="module")
def setup():
    """Reference streams (subprocess) + the same weights converted."""
    specs = request_specs()
    streams, checksum = reference_streams(ENGINE_KW, specs)
    _, _, mine, params = reference_weights()
    assert mine == checksum
    return LM(reduced_config("qwen3-8b")), params, specs, streams


def _tiered_engine(model, params, backend="cuda", **kw):
    sched = uniform_schedule(TIERS, backend=backend)
    return ServeEngine(model, params, Runtime(policy=sched.policy_for(),
                                              schedule=sched),
                       device="cpu", **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_streams_equal_reference_engine(setup, backend):
    model, params, specs, ref = setup
    eng = _tiered_engine(model, params, backend)
    out = eng.run(to_requests(specs))
    assert out == ref
    assert eng.stats.mixed_tier_chunks > 0
    assert sum(eng.stats.tokens_by_tier.values()) == \
        eng.stats.decode_slot_steps


def test_mixed_tiers_equal_fixed_tier_engines(setup):
    """Each request of the mixed-tier run == the same request on an
    untiered engine prepared natively at its tier's precision."""
    model, params, specs, ref = setup
    sched = uniform_schedule(TIERS, backend="cuda")
    for tier in TIERS:
        eng = ServeEngine(model, params, Runtime(policy=sched.policy_for(tier)),
                          device="cpu", **ENGINE_KW)
        mine = [s for s in specs if s["tier"] == tier]
        out = eng.run(to_requests(mine, tiered=False))
        assert out == {s["uid"]: ref[s["uid"]] for s in mine}, tier


def test_fused_equals_per_group_and_no_prepare_after_construction(setup):
    model, params, specs, ref = setup
    before = engine_mod.PREPARE_CALLS
    fused = _tiered_engine(model, params)
    per_group = _tiered_engine(model, params, fused_decode=False)
    assert engine_mod.PREPARE_CALLS == before + 2
    assert per_group.run(to_requests(specs)) == fused.run(to_requests(specs)) \
        == ref
    assert engine_mod.PREPARE_CALLS == before + 2
    # A prepared store is served as is by a second engine.
    again = _tiered_engine(model, fused.params)
    assert engine_mod.PREPARE_CALLS == before + 2
    assert again.run(to_requests(specs[:3])) == {s["uid"]: ref[s["uid"]]
                                               for s in specs[:3]}


def test_streaming_handles_and_events(setup):
    model, params, specs, ref = setup
    eng = _tiered_engine(model, params)
    handles = [eng.submit(r) for r in to_requests(specs)]
    assert all(h.status is RequestStatus.QUEUED for h in handles)
    seen = {h.uid: [] for h in handles}
    handles[0].on_token(lambda ev: seen[ev.uid].append(ev))
    events = eng.step()
    assert {e.uid for e in events} >= {h.uid for h in handles[:4]}
    assert list(handles[5]) == ref[5]           # drives the engine
    eng.drain()
    for h in handles:
        assert h.status is RequestStatus.FINISHED
        assert h.tokens == ref[h.uid]
        assert [e.index for e in h.events] == list(range(len(h.tokens)))
        assert h.events[-1].final and h.events[-1].tier == h.tier
    assert [e.token for e in seen[0]] == ref[0]
    assert eng.clock == eng.stats.decode_steps
    assert not eng.has_work and eng.results == ref


def test_submit_validation_and_unported_features(setup):
    model, params, specs, _ = setup
    eng = _tiered_engine(model, params)
    ok = Request(uid=0, prompt=np.asarray([1, 2], np.int32), max_new_tokens=2)
    eng.submit(ok)
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(ok)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(uid=1, prompt=np.zeros((0,), np.int32)))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(uid=2, prompt=np.ones((60,), np.int32),
                           max_new_tokens=8))
    with pytest.raises(ValueError, match="unknown tier"):
        eng.submit(Request(uid=3, prompt=np.ones((3,), np.int32), tier="3/3"))
    # Sampling and speculation are served (tests/test_torch_spec.py); their
    # parameters are checked at submit.
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        eng.submit(Request(uid=4, prompt=np.ones((3,), np.int32),
                           sampling=SamplingParams(temperature=-1.0)))
    with pytest.raises(ValueError, match="unknown draft tier"):
        eng.submit(Request(uid=5, prompt=np.ones((3,), np.int32),
                           spec=SpecConfig("3/3")))
    # Tier migration and per-tier KV precision are served
    # (tests/test_torch_tiers.py): set_tier re-tags a QUEUED request, and
    # kv_tiers gets the mixed per-slot KV arena.
    eng.handles[0].set_tier("2/2")
    assert eng.handles[0].tier == "2/2"
    assert eng.scheduler.waiting[0].tier == "2/2"
    # Preemption is served (tests/test_torch_overload.py); a QUEUED request
    # has no slot to give up.
    with pytest.raises(RuntimeError, match="only RUNNING"):
        eng.preempt(0)
    with pytest.raises(NotImplementedError, match="item 10"):
        _tiered_engine(model, params, mesh=object())
    kv = uniform_schedule(TIERS, backend="cuda",
                          kv_tiers={"8/8": None, "4/4": 8, "2/2": 8})
    mixed = ServeEngine(model, params, Runtime(policy=kv.policy_for(),
                                               schedule=kv), device="cpu")
    assert all(c.mixed and c.modes == (16, 8) for layer in mixed.arena.caches
               for c in layer.values())
    plain = ServeEngine(model, params,
                        Runtime(policy=uniform_policy(8, 8, backend="cuda")),
                        device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="without a PrecisionSchedule"):
        plain.submit(Request(uid=9, prompt=np.ones((3,), np.int32),
                             tier="8/8"))
    if not torch.cuda.is_available():     # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            ServeEngine(model, params, Runtime(policy=kv.policy_for()))


def test_int8_kv_engine_serves_and_reuses_slots(setup):
    """Fixed precision with an int8 KV arena: more requests than slots, so
    slots are reset and refilled; decomposed == cuda (plain) streams."""
    model, params, specs, _ = setup
    outs = []
    for backend in ("cuda", "decomposed"):
        pol = uniform_policy(4, 8, backend=backend)
        eng = ServeEngine(model, params, Runtime(policy=pol), kv_bits=8,
                          device="cpu", **ENGINE_KW)
        outs.append(eng.run(to_requests(specs, tiered=False)))
        assert eng.stats.prefills == len(specs)
    assert outs[0] == outs[1]
    assert all(len(outs[0][s["uid"]]) == s["max_new"] for s in specs)


def test_slot_helpers_write_in_place():
    model = LM(reduced_config("qwen3-8b"))
    caches = model.init_cache(3, 8, kv_bits=8, device="cpu")
    sub = slots_lib.slot_view(caches, 1)
    sub[0]["pos0"].k.fill_(5)
    sub[0]["pos0"].length.fill_(4)
    assert int(caches[0]["pos0"].k[1].min()) == 5
    assert caches[0]["pos0"].k[0].abs().sum() == 0
    assert caches[0]["pos0"].length.tolist() == [0, 4, 0]
    other = model.init_cache(1, 8, kv_bits=8, device="cpu")
    other[1]["pos0"].v.fill_(3)
    slots_lib.slot_write(caches, other, 2)
    assert int(caches[1]["pos0"].v[2].min()) == 3
    slots_lib.slot_reset(caches, 1)
    assert caches[0]["pos0"].k[1].abs().sum() == 0
    assert caches[0]["pos0"].length.tolist() == [0, 0, 0]


def test_scheduler_fifo():
    s = Scheduler(2)
    for i in range(3):
        s.submit(Request(uid=i, prompt=np.ones((2,), np.int32),
                         max_new_tokens=1), now=float(i))
    assert s.admit(1).uid == 0 and s.admit(0).uid == 1
    assert s.free_slots() == [] and len(s.waiting) == 1
    s.slots[1].emit(7)
    assert s.release_done() == [1] and s.finished == {0: [7]}
    assert s.admit(1).uid == 2 and not s.waiting
    with pytest.raises(ValueError, match="occupied"):
        s.admit(1)
    for slot in (0, 1):
        s.slots[slot].emit(3)
    s.release_done()
    assert not s.has_work and s.finished == {0: [7], 1: [3], 2: [3]}
    assert s.admit(0) is None


@pytest.mark.parametrize("argv", [
    ["--tiers", "8/8", "4/4", "2/2", "--requests", "5"],
    ["--w-bits", "4", "--kv-bits", "8", "--requests", "3"],
    ["--backend", "dense", "--requests", "2"],
    ["--tiers", "8/8", "4/4", "2/2", "--packed", "--requests", "4"],
    ["--w-bits", "6", "--packed", "--backend", "decomposed", "--requests",
     "3"],
    ["--w-bits", "4", "--kv-bits", "4", "--requests", "3"],
    ["--tiers", "8/8", "4/4", "2/2", "--kv-tiers", "bf16", "8", "4",
     "--requests", "5"],
    ["--tiers", "8/8", "4/4", "2/2", "--serialize-tiers", "--requests", "5"],
    ["--baseline", "--kv-bits", "8", "--requests", "5"],
    ["--tiers", "8/8", "4/4", "2/2", "--slo", "--auto-tier", "--requests",
     "6"],
    ["--tiers", "8/8", "4/4", "2/2", "--kv-tiers", "bf16", "8", "4",
     "--migrate-demo", "--decode-chunk", "2", "--requests", "4"]])
def test_serve_cli_on_cpu(argv):
    out = serve_cli.main(["--reduced", "--device", "cpu", "--max-new", "5",
                          "--max-len", "32"] + argv)
    n = int(argv[argv.index("--requests") + 1])
    assert sorted(out) == list(range(n))
    assert all(len(v) == 1 + (5 * (i % 4)) // 3 for i, v in out.items())
