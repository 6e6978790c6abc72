"""repro_torch overload survival (preemption with prefill-free resume,
spill through the checkpoint format, shedding, tenant weights, time
slices) held against the JAX package, on the reduced qwen3-8b with tiers
8/8 4/4 2/2 and ``kv_tiers`` {8/8: bf16, 4/4: 8, 2/2: 4}.

Against the reference: checkpoints restore bit-equal across the two
packages; a preemption snapshot equals the reference's ``slot_view`` of
the same arena, leaf for leaf; ``SLOPolicy``'s overload arithmetic equals
the reference's; and the reference engine (one subprocess for the module,
``XLA_FLAGS=--xla_allow_excess_precision=false``, see _torch_reference.py)
and the port's engine, driven by the same code (``DRIVER``), give equal
streams, statuses, per-uid ticks, suspensions and slots, ``EngineStats``
counters, telemetry counters and tick-clock series (the wall-clock series,
``WALL_SERIES``, are left out) and trace events (their wall-clock ``ts``
and ``dur`` left out; the port's trace holds the reference's events with
every field of theirs, and besides them its host spans).  Within the port: preempt/resume equals an
uninterrupted run for both stores and a sampled request, the guard rails
hold, and a port of ``tests/test_serve_fuzz.py`` drives seeded
interleavings of every operation with its invariants checked after each.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_reference import ROOT, TIERS, reference_weights, request_specs
from repro.checkpoint import checkpoint as jckpt
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.models import layers as jlayers
from repro.serve import scheduler as jscheduler
from repro.serve import slots as jslots
from repro.serve.request import Request as JRequest
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import reduced_config
from repro_torch.convert import to_torch
from repro_torch.core.policy import uniform_schedule
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as tlayers
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import slots as tslots
from repro_torch.serve.engine import EngineStats, ServeEngine, SuspendedState
from repro_torch.serve.handle import RequestStatus
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import SLOPolicy
from repro_torch.spec import SamplingParams, SpecConfig
from repro_torch.telemetry import Telemetry, parse_prometheus

KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}
ENGINE = dict(max_batch=3, max_len=64, decode_chunk=2)
# The integer EngineStats counters, which the two engines must agree on.
STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats)
               if f.type == "int"]
# Telemetry series on the wall clock: they differ run to run.
WALL_SERIES = ("serve_ttft_seconds", "serve_tpot_seconds")

# (a) An explicit schedule: after step n, (n, op, uid, arg).  uid 3 (bf16
# KV), uid 1 (int8, spilled) and uid 2 (int4) are preempted after step 2;
# uid 4 moves from 4/4 to 8/8 (its lanes requantized) and is preempted
# after step 3.  They resume in other slots.
PREEMPT_OPS = [[2, "preempt", 3, False], [2, "preempt", 1, True],
               [2, "preempt", 2, False], [3, "set_tier", 4, "8/8"],
               [3, "preempt", 4, False]]
# (b) The overload policy of chip_smoke.py phase 4d (b), and without time
# slices (so the policy's own displacement fires).
OVERLOAD_POLICY = dict(preempt=True, preempt_slack=4.0, shed=True,
                       tenant_weights={"a": 2.0}, time_slice=2)


def overload_specs(n=9, max_new=6, chunk=2):
    """The reference command line's overload stream (``--slo --preempt
    --shed``): every 3rd request urgent (deadline 2.5 chunks, held until
    the clock reaches 2 chunks, 4 tokens; the last one 3 * max_new, which
    no tier serves in time), the rest best-effort with 3 * max_new tokens;
    tenants "a" and "b" in turn."""
    rng = np.random.default_rng(2)
    urgent = [i for i in range(n) if i % 3 == 2]
    out = []
    for i in range(n):
        s = {"uid": i, "prompt": rng.integers(0, 512, size=4 + i % 5).tolist(),
             "tier": list(TIERS)[i % 3], "tenant": "ab"[i % 2]}
        if i in urgent:
            s.update(deadline=2.5 * chunk, held=True,
                     max_new=3 * max_new if i == urgent[-1] else 4)
        else:
            s.update(max_new=3 * max_new)
        out.append(s)
    return out


RUNS = [
    {"name": "preempt", "requests": request_specs(), "ops": PREEMPT_OPS,
     "hold_until": 0, "spill": True, "policy": None},
    {"name": "overload", "requests": overload_specs(), "hold_until": 4,
     "spill": False, "policy": OVERLOAD_POLICY},
    {"name": "overload-no-slice", "requests": overload_specs(),
     "hold_until": 4, "spill": False,
     "policy": {**OVERLOAD_POLICY, "time_slice": None}},
]

# Drives one engine of either package through a run (exec'd here and in
# the reference's subprocess, so both follow the same code): submits, holds
# the urgent requests back, applies the ops, and records what must agree.
DRIVER = r'''
def drive(eng, Request, run):
    handles, moves = {}, {}
    preempt, resume_into = eng.preempt, eng._resume_into

    def counting(uid):              # every preemption, the policy's too
        moves.setdefault(str(uid), []).append(handles[uid].slot)
        return preempt(uid)

    def resuming(slot, req, sus):
        moves[str(req.uid)].append(slot)
        return resume_into(slot, req, sus)

    eng.preempt, eng._resume_into = counting, resuming

    def submit(s):
        handles[s["uid"]] = eng.submit(Request(
            uid=s["uid"], prompt=np.asarray(s["prompt"], np.int32),
            max_new_tokens=s["max_new"], tier=s["tier"],
            deadline=s.get("deadline"), tenant=s.get("tenant")))

    held = [s for s in run["requests"] if s.get("held")]
    for s in run["requests"]:
        if not s.get("held"):
            submit(s)
    ops = [list(o) for o in run.get("ops", [])]
    n = 0
    while eng.has_work or held:
        eng.step()
        n += 1
        if held and (eng.clock >= run["hold_until"] or not eng.has_work):
            for s in held:
                submit(s)
            held = []
        for op in [o for o in ops if o[0] == n]:
            _, kind, uid, arg = op
            if kind == "set_tier":
                handles[uid].set_tier(arg)
            else:                   # preempt, spilled when arg
                spill_dir = eng._spill_dir
                eng._spill_dir = spill_dir if arg else None
                eng.preempt(uid)
                eng._spill_dir = spill_dir
            ops.remove(op)
    assert not ops, ops
    if eng._spill_dir is not None:
        assert os.listdir(eng._spill_dir) == [], os.listdir(eng._spill_dir)
    tele = eng.telemetry
    return {
        "streams": {str(u): h.tokens for u, h in handles.items()},
        "status": {str(u): h.status.value for u, h in handles.items()},
        "ticks": {str(u): [h.submitted_at, h.admitted_at, h.finished_at]
                  for u, h in handles.items()},
        "moves": moves,
        "stats": {f: getattr(eng.stats, f) for f in STAT_FIELDS},
        "metrics": sorted([name, sorted(map(list, labels)), value]
                          for name, series in parse_prometheus(
                              tele.prometheus()).items()
                          if not name.startswith(WALL_SERIES)
                          for labels, value in series.items()),
        "trace": [[e["tid"], e["name"], e["ph"], e["cat"], e["args"]]
                  for e in tele.tracer.chrome_events() if e["ph"] != "M"],
    }
'''
exec(DRIVER)

REFERENCE = r"""
import hashlib, json, os, sys, tempfile
import jax, numpy as np
from repro.configs import reduced_config
from repro.core.policy import uniform_schedule
from repro.models.layers import Runtime
from repro.models.transformer import LM
from repro.serve import Request, ServeEngine, SLOPolicy
from repro.telemetry import Telemetry, parse_prometheus
spec = json.loads(sys.argv[1])
STAT_FIELDS, WALL_SERIES = spec["stat_fields"], tuple(spec["wall_series"])
exec(spec["driver"])
cfg = reduced_config("qwen3-8b")
model = LM(cfg)
params = model.init(jax.random.PRNGKey(0))
h = hashlib.sha1()
for leaf in jax.tree.leaves(params):
    h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
sched = uniform_schedule({t: tuple(b) for t, b in spec["tiers"].items()},
                         backend="decomposed", kv_tiers=spec["kv_tiers"])
rt = Runtime(policy=sched.policy_for(), mode="serve", schedule=sched)
out = {}
for run in spec["runs"]:
    pol = None if run["policy"] is None else SLOPolicy(
        sched, mac_counts=cfg.quant_layer_macs(), **run["policy"])
    with tempfile.TemporaryDirectory() as d:
        eng = ServeEngine(model, params, rt, scheduler_policy=pol,
                          spill_dir=d if run["spill"] else None,
                          telemetry=Telemetry(), **spec["engine"])
        out[run["name"]] = drive(eng, Request, run)
print(json.dumps({"checksum": h.hexdigest(), "runs": out}))
"""


def _reference(runs) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    arg = json.dumps({"tiers": TIERS, "kv_tiers": KV_TIERS, "engine": ENGINE,
                      "runs": runs, "driver": DRIVER,
                      "stat_fields": STAT_FIELDS,
                      "wall_series": list(WALL_SERIES)})
    return subprocess.Popen([sys.executable, "-c", REFERENCE, arg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _rt(backend="cuda", kv_tiers=KV_TIERS):
    sched = uniform_schedule(TIERS, backend=backend, kv_tiers=kv_tiers)
    return Runtime(policy=sched.policy_for(), schedule=sched)


def _policy(model, kw):
    return None if kw is None else SLOPolicy(
        _rt().schedule, mac_counts=model.cfg.quant_layer_macs(), **kw)


def _port_run(setup, run, backend="cuda"):
    """The port's engine driven through ``run``, its record as JSON sees
    it."""
    model = setup["model"]
    with tempfile.TemporaryDirectory() as d:
        eng = ServeEngine(model, setup["params"], _rt(backend),
                          scheduler_policy=_policy(model, run["policy"]),
                          spill_dir=d if run["spill"] else None,
                          telemetry=Telemetry(), device="cpu", **ENGINE)
        return json.loads(json.dumps(drive(eng, Request, run)))


@pytest.fixture(scope="module")
def setup():
    """The reference engine's records of ``RUNS`` (one subprocess), the
    same weights converted into the port and prepared once, and the
    uninterrupted streams of the port."""
    proc = _reference(RUNS)
    _, _, mine, params = reference_weights()      # while the reference runs
    model = LM(reduced_config("qwen3-8b"))
    eng = ServeEngine(model, params, _rt(), device="cpu", **ENGINE)
    plain = eng.run(_requests(request_specs()))
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert mine == ref["checksum"]
    return {"model": model, "params": eng.params, "float_params": params,
            "ref": ref["runs"], "plain": plain}


def _requests(specs, **kw):
    return [Request(uid=s["uid"], prompt=np.asarray(s["prompt"], np.int32),
                    max_new_tokens=s["max_new"], tier=s["tier"],
                    deadline=s.get("deadline"), tenant=s.get("tenant"), **kw)
            for s in specs]


def _engine(setup, backend="cuda", params=None, **kw):
    return ServeEngine(setup["model"], params or setup["params"],
                       _rt(backend), device="cpu", **{**ENGINE, **kw})


# ------------------------------------------------------------ checkpoint
def _tree(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.ones((2,), dtype=torch.bfloat16)}}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"data_step": 7})
    restored, extra = ckpt.restore(str(tmp_path), 7, _tree(1))
    assert extra == {"data_step": 7}
    for a, b in zip(_leaves(t), _leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 12):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 12
    ckpt.gc_old(str(tmp_path), keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [9, 12]


def test_interrupted_save_is_ignored(tmp_path):
    """A .tmp dir from a crash mid-save is not a checkpoint."""
    ckpt.save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000008.tmp")
    with open(tmp_path / "step_00000008.tmp" / "leaf_00000.npy", "w") as f:
        f.write("garbage")
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_corrupt_manifest_dir_skipped(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    os.makedirs(tmp_path / "step_00000005")          # no manifest.json
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros((3, 3))})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros((2, 2)),
                                        "b": torch.zeros((2,))})


def test_async_checkpointer(tmp_path):
    acp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        acp.save(s, _tree(s))
    acp.wait()
    assert ckpt.list_steps(str(tmp_path)) == [2, 3]
    restored, _ = ckpt.restore(str(tmp_path), 3, _tree())
    assert torch.equal(restored["a"], _tree(3)["a"])


def _mixed_tree():
    """A nested dict (and list) of int8, uint8, int32, f32 and bf16 arrays
    as numpy: bf16 through its uint16 bits."""
    rng = np.random.default_rng(5)
    bf16 = jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
    return {"w": rng.integers(-128, 128, (4, 6)).astype(np.int8),
            "codes": [rng.integers(0, 256, (7,)).astype(np.uint8),
                      rng.integers(-9, 9, (2, 2)).astype(np.int32)],
            "deep": {"f": rng.normal(size=(5,)).astype(np.float32),
                     "h": np.asarray(bf16)}}


def _as_port(tree):
    """The tree as the port holds it: torch tensors."""
    return jax.tree.map(lambda a: to_torch(a, "cpu"), tree)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def _bits(a):
    """(the bits, the dtype name) of a leaf of either package."""
    if isinstance(a, torch.Tensor):
        return _tbits(a), str(a.dtype).replace("torch.", "")
    return _jbits(a), np.asarray(a).dtype.name


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """The same tree saved by either package restores bit-equal (values
    and dtypes) in the other; both write the same manifest."""
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    ckpt.save(str(tmp_path / "port"), 1, _as_port(tree), extra={"k": 1})
    jckpt.save(str(tmp_path / "reference"), 1, jtree, extra={"k": 1})
    manifests = [json.load(open(tmp_path / w / "step_00000001" /
                                "manifest.json"))
                 for w in ("port", "reference")]
    assert manifests[0] == manifests[1]
    if writer == "port":
        got, extra = jckpt.restore(str(tmp_path / "port"), 1, jtree)
        got = jax.tree.leaves(got)
    else:
        got, extra = ckpt.restore(str(tmp_path / "reference"), 1,
                                  _as_port(tree))
        got = _leaves(got)
    assert extra == {"k": 1}
    for want, have in zip(jax.tree.leaves(tree), got, strict=True):
        (wb, wd), (hb, hd) = _bits(want), _bits(have)
        assert wd == hd
        np.testing.assert_array_equal(wb, hb)


# -------------------------------------------------------------- snapshot
B, S, KVH, DH, PERIODS = 3, 12, 2, 16, 2
LENS = np.asarray([7, 4, 6], np.int32)
MODES = {"bf16": (None, None), "int8": (8, None), "int4": (4, None),
         "mixed": ((16, 8, 4), (8, 4, 16))}
FIELDS = ("k", "v", "k_scale", "v_scale", "length", "kv_bits")


@jax.jit
def _jview(arena, slot):
    return jslots.slot_view(arena, slot)


@jax.jit
def _jwrite(arena, sub, slot):
    return jslots.slot_write(arena, sub, slot)


def _arenas(kv_bits, codes):
    """The same prefilled arena of PERIODS layers in both packages: the
    reference's (jitted update, stacked as ``LM.init_cache`` stacks it)
    and the port's (one dict per layer)."""
    rng = np.random.default_rng(4)

    def jperiod(k, v):
        c = jlayers.KVCache.create(B, S, KVH, DH, kv_bits=kv_bits)
        if codes is not None:
            c = dataclasses.replace(c, kv_bits=jnp.asarray(codes, jnp.int32))
        return c.update(k, v, 0, new_length=jnp.asarray(LENS))

    periods, arena = [], []
    for _ in range(PERIODS):
        k, v = (jnp.asarray(rng.normal(size=(B, 7, KVH, DH)) * 2,
                            jnp.bfloat16) for _ in range(2))
        periods.append(jax.jit(jperiod)(k, v))
        c = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=kv_bits,
                                   device="cpu")
        if codes is not None:
            c.kv_bits.copy_(torch.tensor(codes, dtype=torch.int32))
        c.update(to_torch(k, "cpu"), to_torch(v, "cpu"), 0,
                 new_length=torch.from_numpy(LENS))
        arena.append({"pos0": c})
    return {"pos0": jax.tree.map(lambda *a: jnp.stack(a), *periods)}, arena


def _assert_arena_equal(jarena, arena):
    for f in FIELDS:
        want = getattr(jarena["pos0"], f)
        if want is None:
            assert getattr(arena[0]["pos0"], f) is None
            continue
        got = np.stack([_tbits(getattr(layer["pos0"], f)) for layer in arena])
        np.testing.assert_array_equal(_jbits(want), got, err_msg=f)


def _assert_snapshot_equal(jsub, snap):
    """The port's snapshot equals the reference's slot view, leaf for
    leaf (raw lanes, scales, length, tier code)."""
    names = {f for f in FIELDS if getattr(jsub["pos0"], f) is not None}
    assert all(set(layer["pos0"]) == names for layer in snap)
    for f in names:
        got = np.stack([_tbits(layer["pos0"][f]) for layer in snap])
        np.testing.assert_array_equal(_jbits(getattr(jsub["pos0"], f)), got,
                                      err_msg=f)


@pytest.mark.parametrize("mode", list(MODES))
def test_snapshot_equals_reference_slot_view(mode, tmp_path):
    """Slot 1's snapshot equals the reference's ``slot_view``; it is a
    copy (resetting the slot leaves it as it was); written into slot 2 it
    gives the reference's ``slot_write``; and it survives a spill through
    the checkpoint format bit for bit."""
    jarena, arena = _arenas(*MODES[mode])
    _assert_arena_equal(jarena, arena)
    jsub = _jview(jarena, jnp.int32(1))
    snap = tslots.slot_snapshot(arena, 1)
    _assert_snapshot_equal(jsub, snap)
    assert tslots.snapshot_nbytes(snap) == sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(jsub))
    tslots.slot_reset(arena, 1)
    _assert_snapshot_equal(jsub, snap)
    tslots.slot_restore(arena, snap, 2)
    jarena = _jwrite(jarena, jsub, jnp.int32(2))
    jarena = _jwrite(jarena, jax.tree.map(jnp.zeros_like, jsub),
                     jnp.int32(1))
    _assert_arena_equal(jarena, arena)
    ckpt.save(str(tmp_path), 0, snap)
    back, _ = ckpt.restore(str(tmp_path), 0, tslots.slot_template(arena))
    _assert_snapshot_equal(jsub, back)


# --------------------------------------------------- hybrid (SSM) snapshot
HYBRID = "jamba-1.5-large-398b"


def _hybrid_arenas():
    """The reduced jamba arena (seven Mamba positions, one attention
    position) in both packages, every tensor of every slot filled with the
    same random values: the reference's (``LM.init_cache``, stacked over
    periods) and the port's (one dict per period)."""
    from repro.configs import reduced_config as jreduced
    from repro.models.transformer import LM as JLM
    jarena = JLM(jreduced(HYBRID)).init_cache(B, S)
    arena = LM(reduced_config(HYBRID)).init_cache(B, S, device="cpu")
    rng = np.random.default_rng(8)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jarena)
    filled = []
    for path, leaf in leaves:
        pos, field = path[0].key, path[1].name
        if np.issubdtype(np.asarray(leaf).dtype, np.integer):
            arr = rng.integers(0, S, size=leaf.shape).astype(leaf.dtype)
        else:
            arr = np.asarray(jnp.asarray(rng.normal(size=leaf.shape),
                                         leaf.dtype))
        filled.append(jnp.asarray(arr))
        for i, layer in enumerate(arena):
            getattr(layer[pos], field).copy_(to_torch(arr[i], "cpu"))
    return jax.tree_util.tree_unflatten(treedef, filled), arena


def _assert_spill_tree_equal(jsub, tree):
    """A spill tree (``slots.spill_tree``) against the reference's slot
    view: the same keystr paths in the same order, bits and dtypes."""
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jsub)[0]]
    got = ckpt._flatten(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p.endswith(".conv") for p, _ in got)
    for (p, w), (_, g) in zip(want, got):
        (wb, wd), (gb, gd) = _bits(w), _bits(g)
        assert wd == gd, p
        np.testing.assert_array_equal(wb, gb, err_msg=p)


def test_hybrid_snapshot_equals_reference_slot_view(tmp_path):
    """Slot 1 of the hybrid arena: the port's snapshot (SSM conv windows
    and states beside the KV lanes) is, leaf for leaf and under the
    reference's names, the reference's ``slot_view``; written into slot 2
    it gives the reference's ``slot_write``; and a spill file written by
    either package restores bit-equal in the other."""
    jarena, arena = _hybrid_arenas()
    jsub = _jview(jarena, jnp.int32(1))
    snap = tslots.slot_snapshot(arena, 1)
    tree = tslots.spill_tree(snap)
    _assert_spill_tree_equal(jsub, tree)
    assert tslots.snapshot_nbytes(snap) == sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(jsub))
    tslots.slot_restore(arena, snap, 2)
    jarena = _jwrite(jarena, jsub, jnp.int32(2))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jarena)[0]:
        pos, field = path[0].key, path[1].name
        got = np.stack([_tbits(getattr(layer[pos], field))
                        for layer in arena])
        np.testing.assert_array_equal(_jbits(leaf), got,
                                      err_msg=jax.tree_util.keystr(path))
    # The port's spill file, restored by the reference.
    ckpt.save(str(tmp_path / "port"), 0, tree)
    back, _ = jckpt.restore(str(tmp_path / "port"), 0,
                            jax.tree.map(jnp.zeros_like, jsub))
    _assert_spill_tree_equal(back, tree)
    # The reference's spill file, restored by the port.
    jckpt.save(str(tmp_path / "reference"), 0, jsub)
    got, _ = ckpt.restore(str(tmp_path / "reference"), 0,
                          tslots.spill_template(arena))
    _assert_spill_tree_equal(jsub, got)
    restored = tslots.unspill_tree(got)
    for layer, want in zip(restored, snap, strict=True):
        for pos, fields in want.items():
            assert fields.keys() == layer[pos].keys()
            for f, t in fields.items():
                assert torch.equal(layer[pos][f], t), (pos, f)


def test_preempt_resume_hybrid_equals_uninterrupted(tmp_path):
    """Preempted hybrid slots (conv windows and SSD states in the
    snapshot, one of them spilled) resume prefill-free in other slots to
    the streams of an uninterrupted run."""
    m = LM(reduced_config(HYBRID))
    sched = uniform_schedule(TIERS, backend="cuda")
    gen = torch.Generator()
    gen.manual_seed(1)
    params = m.init(gen, device="cpu")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    reqs = _requests(request_specs()[:6])
    kw = dict(max_batch=3, max_len=64, decode_chunk=2, device="cpu")
    base = ServeEngine(m, params, rt, **kw)
    want = base.run([dataclasses.replace(r) for r in reqs])
    eng = ServeEngine(m, base.params, rt, spill_dir=str(tmp_path), **kw)
    got, done = _preempt_everything(eng, reqs)
    assert got == want
    assert len(done) == eng.stats.preemptions == eng.stats.resumes >= 3
    assert eng.stats.spill_bytes > 0 and os.listdir(tmp_path) == []


# ------------------------------------------------------- policy arithmetic
POLICIES = [dict(preempt=True), dict(preempt=True, preempt_slack=3.0),
            dict(shed=True), dict(shed=True, auto_tier=True),
            dict(shed=True, preempt=True, tenant_weights={"a": 2.0}),
            dict(tenant_weights={"a": 3.0, "b": 1.5})]


def _pair(rng, uid, tiers):
    spec = dict(uid=uid, max_new_tokens=int(rng.integers(1, 20)),
                tier=tiers[int(rng.integers(0, 3))],
                deadline=None if rng.random() < 0.3
                else float(rng.integers(1, 120)),
                tenant=[None, "a", "b"][int(rng.integers(0, 3))])
    return (Request(prompt=np.ones(2, np.int32), **spec),
            JRequest(prompt=np.ones(2, np.int32), **spec))


@pytest.mark.parametrize("kw", POLICIES, ids=[
    "preempt", "preempt-slack", "shed", "shed-auto", "shed-preempt-tenant",
    "tenants"])
def test_overload_arithmetic_matches_reference(kw):
    """``select``, ``weighted_slack``, ``preempt_victim`` and
    ``admission_decision`` equal the reference SLOPolicy's on random
    queues, running sets and suspended remainders."""
    rng = np.random.default_rng(17)
    tiers = list(TIERS)
    mine = SLOPolicy(uniform_schedule(TIERS), **kw)
    ref = jscheduler.SLOPolicy(juniform_schedule(TIERS), **kw)
    assert mine.tier_costs == ref.tier_costs
    for _ in range(60):
        n_wait, n_run = int(rng.integers(0, 6)), int(rng.integers(0, 4))
        pairs = [_pair(rng, i, tiers) for i in range(n_wait + n_run + 1)]
        sub = {i: float(rng.integers(0, 40)) for i in range(len(pairs))}
        now = float(rng.integers(40, 80))
        owed = {i: int(rng.integers(1, 10)) for i in range(n_wait)
                if rng.random() < 0.3}
        mine.remaining_tokens, ref.remaining_tokens = dict(owed), dict(owed)
        wait, jwait = ([p[j] for p in pairs[:n_wait]] for j in (0, 1))
        run = [(i, pairs[n_wait + i][0], int(rng.integers(0, 12)),
                float(rng.integers(0, 40))) for i in range(n_run)]
        jrun = [(s, pairs[n_wait + s][1], rem, tick)
                for s, _, rem, tick in run]
        assert mine.select(wait, sub, now) == ref.select(jwait, sub, now)
        for r, jr in zip(wait, jwait):
            assert mine.weighted_slack(r, sub, now) == \
                ref.weighted_slack(jr, sub, now)
            assert mine.est_service(r) == ref.est_service(jr)
        assert mine.preempt_victim(wait, run, sub, now) == \
            ref.preempt_victim(jwait, jrun, sub, now)
        new, jnew = pairs[-1]
        slots = int(rng.integers(1, 4))
        assert mine.admission_decision(new, wait, run, slots, sub, now) == \
            ref.admission_decision(jnew, jwait, jrun, slots, sub, now)
    with pytest.raises(ValueError, match="weight"):
        SLOPolicy(tenant_weights={"x": 0.5})
    with pytest.raises(ValueError, match="time_slice"):
        SLOPolicy(time_slice=0)


# ---------------------------------------------- engine against reference
@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_preempt_schedule_equals_reference_engine(setup, backend):
    """Three KV modes preempted (one spilled), a migration before a
    preemption, resumes into other slots: everything the driver records
    equals the reference engine's, and the requests left at their tier
    give their uninterrupted streams."""
    got = _port_run(setup, RUNS[0], backend)
    want = setup["ref"]["preempt"]
    for key in ("streams", "status", "ticks", "moves", "stats"):
        assert got[key] == want[key], key
    assert got["stats"]["preemptions"] == 4 == got["stats"]["resumes"]
    assert got["stats"]["spill_bytes"] > 0
    assert any(m[0] != m[1] for m in got["moves"].values())
    for uid, toks in got["streams"].items():
        if uid != "4":                     # uid 4 moved to 8/8
            assert toks == setup["plain"][int(uid)], uid


@pytest.mark.parametrize("run", RUNS[1:], ids=lambda r: r["name"])
def test_overload_stream_equals_reference_engine(setup, run):
    """The overload stream under SLOPolicy(preempt, shed, tenant weights,
    with and without time slices): equal to the reference engine's; every
    FINISHED stream equals its uninterrupted run."""
    got = _port_run(setup, run)
    want = setup["ref"][run["name"]]
    for key in ("streams", "status", "ticks", "moves", "stats"):
        assert got[key] == want[key], key
    st = got["stats"]
    assert st["sheds"] > 0 and st["preemptions"] == st["resumes"] > 0
    if run["policy"]["time_slice"] is None:
        assert st["time_slice_preemptions"] == 0
    else:
        assert st["time_slice_preemptions"] > 0
    eng = _engine(setup)
    plain = eng.run(_requests(run["requests"]))
    for uid, toks in got["streams"].items():
        if got["status"][uid] == "finished":
            assert toks == plain[int(uid)], uid


@pytest.mark.parametrize("name", [r["name"] for r in RUNS])
def test_telemetry_equals_reference_engine(setup, name):
    """Every telemetry counter, gauge and tick-clock histogram (the
    wall-clock ones, ``WALL_SERIES``, left out) and every trace event but
    its wall-clock time equal the reference engine's.  The port's trace
    also holds the engine's and the model's host spans (category
    ``host``), and its dispatch spans carry span ids and fields the
    reference does not record: every event and field of the reference's is
    there, in the same order."""
    run = next(r for r in RUNS if r["name"] == name)
    got = _port_run(setup, run)
    want = setup["ref"][name]
    assert got["metrics"] == want["metrics"]
    mine = [ev for ev in got["trace"] if ev[3] != "host"]
    assert [ev[:4] for ev in mine] == [ev[:4] for ev in want["trace"]]
    for ev, ref in zip(mine, want["trace"]):
        assert {k: ev[4].get(k, "missing") for k in ref[4]} == ref[4], ev
    assert len(mine) < len(got["trace"])
    names = {m[0] for m in got["metrics"]}
    assert {"serve_preemptions", "serve_queue_wait_ticks_bucket",
            "serve_ttft_ticks_sum", "serve_modeled_cycle_utilization"} \
        <= names
    assert not any(n.startswith(WALL_SERIES) for n in names)


# --------------------------------------------------- invariants (port)
def _preempt_everything(eng, reqs, spill_every=2):
    """Serve ``reqs``, preempting every request once after it streamed 2
    tokens (every ``spill_every``-th one spilled)."""
    handles = {r.uid: eng.submit(r) for r in reqs}
    done = []
    while eng.has_work:
        eng.step()
        for uid, h in handles.items():
            if uid not in done and h.status is RequestStatus.RUNNING \
                    and len(h.tokens) >= 2:
                spill_dir = eng._spill_dir
                if len(done) % spill_every:
                    eng._spill_dir = None
                sus = eng.preempt(uid)
                eng._spill_dir = spill_dir
                assert isinstance(sus, SuspendedState)
                assert h.status is RequestStatus.SUSPENDED
                assert sus.tokens == h.tokens
                done.append(uid)
    assert eng.suspended == {}
    return {uid: h.tokens for uid, h in handles.items()}, done


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_preempt_resume_equals_uninterrupted(setup, tmp_path, packed):
    """Every request preempted once (half of them spilled), a sampled one
    among them: the streams equal the uninterrupted run's, for both
    stores; the spill dir ends empty."""
    params = setup["float_params"] if packed else None
    sp = SamplingParams(0.8, 40, 5)
    reqs = _requests(request_specs())
    reqs[4] = dataclasses.replace(reqs[4], sampling=sp)
    base = _engine(setup, params=params, packed=packed)
    want = base.run([dataclasses.replace(r) for r in reqs])
    eng = _engine(setup, params=base.params, spill_dir=str(tmp_path))
    got, done = _preempt_everything(eng, reqs)
    assert got == want
    assert len(done) == eng.stats.preemptions == eng.stats.resumes >= 6
    assert eng.stats.spill_bytes > 0 and os.listdir(tmp_path) == []
    if not packed:
        assert {u: got[u] for u in got if u != 4} == \
            {u: v for u, v in setup["plain"].items() if u != 4}


def test_preempt_after_migration_equals_migrated_run(setup):
    """set_tier (bf16 lanes requantized to int4) then preempt: the snapshot
    carries the migrated lanes and the stream equals the same migration
    without the preemption."""
    req = _requests(request_specs()[6:7])[0]        # 8/8, 7 tokens

    def serve(preempt):
        eng = _engine(setup)
        h = eng.submit(dataclasses.replace(req))
        while len(h.tokens) < 3:
            eng.step()
        h.set_tier("2/2")
        if preempt:
            eng.preempt(req.uid)
        eng.drain()
        assert eng.stats.kv_migrations == 1
        return h.tokens

    assert serve(True) == serve(False)


def test_guard_rails(setup):
    """As reference tests/test_preemption.py:279: preempt from an on_token
    callback raises (deferred to the round's end, the round completes),
    cancel of a RUNNING request and set_tier of a SUSPENDED one raise."""
    eng = _engine(setup, max_batch=1)
    r0, r1 = _requests(request_specs()[1:3])
    h0, h1 = eng.submit(r0), eng.submit(r1)
    errs = []

    def cb(ev):
        try:
            eng.preempt(ev.uid)
        except RuntimeError as e:
            errs.append(e)

    h0.on_token(cb)
    with pytest.raises(KeyError):
        eng.preempt(99)
    with pytest.raises(RuntimeError, match="only RUNNING"):
        eng.preempt(r0.uid)                  # still QUEUED
    eng.step()
    assert errs and "scheduling round" in str(errs[0])
    with pytest.raises(RuntimeError, match="preempt it first"):
        eng.cancel(r0.uid)                   # RUNNING
    eng.preempt(r0.uid)                      # between rounds: fine
    with pytest.raises(RuntimeError, match="suspended"):
        h0.set_tier("2/2")                   # snapshot pinned at its tier
    with pytest.raises(RuntimeError, match="only RUNNING"):
        eng.preempt(r0.uid)                  # already SUSPENDED
    eng.drain()
    with pytest.raises(RuntimeError):
        eng.cancel(r0.uid)                   # already FINISHED
    assert h0.done and h1.done
    assert h0.tokens == setup["plain"][r0.uid]

    def boom(ev):
        raise ValueError("callback")
    eng2 = _engine(setup)
    h = eng2.submit(_requests(request_specs()[2:3])[0])
    h.on_token(boom)
    with pytest.raises(ValueError, match="callback"):
        eng2.step()                          # raised after the round
    assert eng2.stats.decode_chunks == 1 and len(h.tokens) == 3


def test_cancel_and_retire_release_everything(setup, tmp_path):
    """Cancelling a SUSPENDED request removes its spill dir; retiring every
    terminal request leaves no host state, with the suspension residue put
    back to prove retire clears it on its own."""
    pol = SLOPolicy(_rt().schedule, preempt=True)
    eng = _engine(setup, spill_dir=str(tmp_path), scheduler_policy=pol)
    r0, r1 = _requests(request_specs()[1:3])
    h0 = eng.submit(r0)
    eng.step()
    sus = eng.preempt(r0.uid)
    eng._spiller.wait()
    assert (tmp_path / "step_00000000" / "manifest.json").exists()
    assert r0.uid in pol.remaining_tokens
    eng.cancel(r0.uid)
    assert h0.status is RequestStatus.SHED and not eng.has_work
    assert os.listdir(tmp_path) == [] and pol.remaining_tokens == {}
    eng._suspended[r0.uid] = sus
    pol.remaining_tokens[r0.uid] = 5
    h1 = eng.submit(r1)
    eng.drain()
    assert eng.retire(r0.uid) == h0.tokens and eng.retire(r1.uid) == h1.tokens
    assert eng.handles == {} and eng.suspended == {} and eng.results == {}
    assert pol.remaining_tokens == {} and eng._seen_uids == set()


def test_time_slices(setup):
    """Three long best-effort requests over one slot: with slices every
    request starts before the first finishes and the streams stay equal;
    no slice fires without waiters or on a deadlined slot."""
    specs = [dict(s, max_new=12, tier="8/8") for s in request_specs()[:3]]

    def serve(policy, max_batch=1, specs=specs):
        eng = _engine(setup, max_batch=max_batch, scheduler_policy=policy)
        first = {}
        for r in _requests(specs):
            eng.submit(r)
        while eng.has_work:
            for ev in eng.step():
                first.setdefault(ev.uid, eng.clock)
        return eng, first

    sched = _rt().schedule
    fifo, first_fifo = serve(None)
    sliced, first_ts = serve(SLOPolicy(sched, time_slice=4))
    assert sliced.results == fifo.results
    assert sliced.stats.time_slice_preemptions > 0
    assert first_ts[2] < first_fifo[2]
    idle, _ = serve(SLOPolicy(sched, time_slice=1), max_batch=3)
    assert idle.stats.time_slice_preemptions == 0
    urgent, _ = serve(SLOPolicy(sched, time_slice=2), specs=[
        dict(specs[0], deadline=1000.0), specs[1]])
    assert urgent.stats.time_slice_preemptions == 0


def test_decode_dispatch_count_on_the_cpu(setup):
    """On the CPU the kernels' plain versions launch nothing: every layout
    counts 0, and a counting step changes no cache tensor."""
    eng = _engine(setup, count_dispatches=True)
    for r in _requests(request_specs()):
        eng.submit(r)
    eng.step()
    before = [t.clone() for layer in eng.arena.caches
              for c in layer.values() for t in c.tensors()]
    groups = eng._group_layout()[0]
    assert eng.decode_dispatch_count(groups=groups) == 0
    assert eng.decode_dispatch_count(tier="2/2") == 0
    after = [t for layer in eng.arena.caches for c in layer.values()
             for t in c.tensors()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    eng.drain()
    assert eng.stats.decode_dispatches and \
        set(eng.stats.decode_dispatches.values()) == {0}


# ------------------------------------------------------------- fuzz harness
# Port of tests/test_serve_fuzz.py: (prompt length, max_new, deadline,
# tenant) profiles; one warm engine with every overload feature and live
# telemetry, seeded interleavings of every operation, the invariants after
# each, and the streams against unpressured references at the end.
PROFILES = [(3, 4, None, None), (5, 6, None, "gold"), (4, 8, None, None),
            (6, 3, 200.0, None), (4, 5, 120.0, "gold"), (7, 7, None, None)]
FUZZ_SEEDS = 16


@pytest.fixture(scope="module")
def fuzz_engine():
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    rt = _rt()
    pol = SLOPolicy(rt.schedule, preempt=True, preempt_slack=4.0, shed=True,
                    tenant_weights={"gold": 2.0}, time_slice=6)
    eng = ServeEngine(model, model.init(gen, device="cpu"), rt,
                      scheduler_policy=pol, telemetry=Telemetry(),
                      device="cpu", **ENGINE)
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
               for p, _, _, _ in PROFILES]
    batch = [(p, tier, Request(uid=i, prompt=prompts[p],
                               max_new_tokens=PROFILES[p][1], tier=tier))
             for i, (p, tier) in enumerate((p, t) for p in range(len(PROFILES))
                                           for t in TIERS)]
    out = eng.run([r for _, _, r in batch])
    refs = {(p, tier): out[r.uid] for p, tier, r in batch}
    for _, _, r in batch:
        eng.retire(r.uid)
    _assert_empty(eng)
    return eng, prompts, refs, [len(batch)]


def _assert_empty(eng):
    """The leak check: no per-request state left, host or scheduler."""
    assert not eng.has_work and eng.handles == {} and eng.suspended == {}
    assert eng._seen_uids == set() and list(eng.scheduler.waiting) == []
    assert eng.scheduler.submitted_at == {} and eng.scheduler.finished == {}
    assert all(s is None for s in eng.scheduler.slots)
    assert all(t is None for t in eng.arena.tiers)
    assert eng.scheduler.policy.remaining_tokens == {}


def _check_invariants(eng):
    st_ = eng.stats
    assert st_.decode_slot_steps + st_.decode_idle_slot_steps \
        == st_.decode_steps * ENGINE["max_batch"]
    reg = eng.telemetry.registry
    for f in dataclasses.fields(st_):
        v = getattr(st_, f.name)
        if isinstance(v, int):
            assert reg.value("serve_" + f.name) == float(v), f.name
    for tier, n in st_.tokens_by_tier.items():
        assert reg.value("serve_tokens_by_tier", tier=tier) == float(n)
    running = set()
    for slot, state in eng.scheduler.occupied():
        h = eng.handles[state.uid]
        assert h.status is RequestStatus.RUNNING and h.slot == slot
        assert eng.arena.tiers[slot] == state.request.tier is not None
        running.add(state.uid)
    for slot in eng.scheduler.free_slots():
        assert eng.arena.tiers[slot] is None
    waiting = [r.uid for r in eng.scheduler.waiting]
    assert len(waiting) == len(set(waiting)) and running.isdisjoint(waiting)
    suspended = set(eng.suspended)
    assert suspended <= set(waiting)
    assert set(eng.scheduler.policy.remaining_tokens) <= suspended
    for uid, h in eng.handles.items():
        assert h.tokens == [e.token for e in h.events]
        assert [e.index for e in h.events] == list(range(len(h.events)))
        assert all(not e.final for e in h.events[:-1])
        if h.status is RequestStatus.SUSPENDED:
            assert eng.suspended[uid].tokens == h.tokens
        elif h.status is RequestStatus.FINISHED:
            assert len(h.tokens) == h.request.max_new_tokens
            assert eng.scheduler.finished.get(uid) == h.tokens
        elif h.status is RequestStatus.QUEUED:
            assert uid in waiting and uid not in suspended


def _interleave(fuzz, seed, n_ops=24):
    eng, prompts, refs, counter = fuzz
    rng = np.random.default_rng(seed)
    tiers = list(TIERS)
    live, cut = {}, set()

    def submit_one():
        uid = counter[0]
        counter[0] += 1
        p = int(rng.integers(len(PROFILES)))
        _, max_new, deadline, tenant = PROFILES[p]
        spec = SpecConfig("4/4", 2) if rng.random() < 0.2 else None
        h = eng.submit(Request(uid=uid, prompt=prompts[p],
                               max_new_tokens=max_new,
                               tier=tiers[int(rng.integers(3))],
                               deadline=deadline, tenant=tenant, spec=spec))
        live[uid] = (p, h)
        if h.status is RequestStatus.SHED:
            cut.add(uid)

    def with_status(status):
        return [u for u, (_, h) in live.items() if h.status is status]

    for _ in range(n_ops):
        op = rng.choice(["submit", "step", "step", "preempt", "set_tier",
                         "cancel", "retire"])
        if op == "submit" and len(live) < 12:
            submit_one()
        elif op == "step":
            eng.step()
        elif op == "preempt" and with_status(RequestStatus.RUNNING):
            uids = with_status(RequestStatus.RUNNING)
            eng.preempt(uids[int(rng.integers(len(uids)))])
        elif op == "set_tier" and with_status(RequestStatus.QUEUED):
            uids = with_status(RequestStatus.QUEUED)
            live[uids[int(rng.integers(len(uids)))]][1].set_tier(
                tiers[int(rng.integers(3))])
        elif op == "cancel":
            uids = with_status(RequestStatus.QUEUED) + \
                with_status(RequestStatus.SUSPENDED)
            if uids:
                u = uids[int(rng.integers(len(uids)))]
                eng.cancel(u)
                cut.add(u)
        elif op == "retire":
            done = [u for u, (_, h) in live.items() if h.done]
            if done:
                u = done[int(rng.integers(len(done)))]
                assert eng.retire(u) == live.pop(u)[1].tokens
        _check_invariants(eng)
    while eng.has_work:
        eng.step()
        _check_invariants(eng)
    for uid, (p, h) in live.items():
        if uid in cut:
            assert h.status is RequestStatus.SHED
        else:
            assert h.status is RequestStatus.FINISHED
            assert h.tokens == refs[(p, h.tier)], (uid, p, h.tier)
        assert eng.retire(uid) == h.tokens
    _assert_empty(eng)


def test_fuzz_seeded_interleavings(fuzz_engine):
    eng = fuzz_engine[0]
    before = dataclasses.replace(eng.stats)
    for seed in range(FUZZ_SEEDS):
        _interleave(fuzz_engine, seed)
    assert eng.stats.spec_rounds > before.spec_rounds
    assert eng.stats.preemptions > before.preemptions
    assert eng.stats.sheds > before.sheds


def test_fuzz_overload_heavy(fuzz_engine):
    """Bursts of 2-3x the slots, a third with tight deadlines: the
    policy's preemption or shedding fires; finished streams equal their
    references."""
    eng, prompts, refs, counter = fuzz_engine
    before = (eng.stats.preemptions, eng.stats.sheds)
    for seed in range(6):
        rng = np.random.default_rng(10_000 + seed)
        live = {}
        for _ in range(int(rng.integers(6, 10))):
            uid = counter[0]
            counter[0] += 1
            p = int(rng.integers(len(PROFILES)))
            _, max_new, deadline, tenant = PROFILES[p]
            if rng.random() < 0.3:
                deadline = 30.0
            live[uid] = (p, eng.submit(Request(
                uid=uid, prompt=prompts[p], max_new_tokens=max_new,
                tier=list(TIERS)[int(rng.integers(3))], deadline=deadline,
                tenant=tenant)))
        while eng.has_work:
            eng.step()
            _check_invariants(eng)
        for uid, (p, h) in live.items():
            if h.status is RequestStatus.FINISHED:
                assert h.tokens == refs[(p, h.tier)]
            eng.retire(uid)
        _assert_empty(eng)
    assert (eng.stats.preemptions, eng.stats.sheds) != before


@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
@settings(max_examples=8, deadline=None, database=None)
def test_fuzz_hypothesis_interleavings(fuzz_engine, seed):
    _interleave(fuzz_engine, seed)


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv,error", [
    (["--tiers", "8/8", "4/4", "--preempt"], "they need --slo"),
    (["--tiers", "8/8", "4/4", "--shed"], "they need --slo"),
    (["--tiers", "8/8", "4/4", "--slo", "--spill-dir", "x"],
     "it needs --preempt")])
def test_serve_cli_errors(argv, error, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--reduced", "--device", "cpu"] + argv)
    assert error in capsys.readouterr().err


def test_serve_cli_overload_run(tmp_path, capsys):
    """The overload stream with every new flag: the report ends the run,
    with the shed uids; the spill dir ends empty; the metrics and the
    trace are written."""
    spill, prom, trace = (tmp_path / "spill", tmp_path / "m.prom",
                          tmp_path / "t.json")
    out = serve_cli.main([
        "--reduced", "--device", "cpu", "--tiers", "8/8", "4/4", "2/2",
        "--kv-tiers", "bf16", "8", "4", "--slo", "--preempt", "--shed",
        "--requests", "9", "--max-new", "6", "--max-len", "64",
        "--decode-chunk", "2", "--spill-dir", str(spill), "--metrics",
        str(prom), "--trace-out", str(trace), "--profile"])
    printed = capsys.readouterr().out
    assert sorted(out) == list(range(9))
    assert "overload: preemptions=" in printed
    shed = json.loads(printed.split("shed_uids=")[1].splitlines()[0])
    assert 8 in shed and out[8] == []
    assert os.listdir(spill) == []
    parsed = parse_prometheus(prom.read_text())
    assert parsed["serve_preemptions"][()] > 0
    assert parsed["serve_sheds"][()] == float(len(shed))
    assert json.loads(trace.read_text())["traceEvents"]
    assert '"decode_chunk"' in printed.split("profile: ")[1]
