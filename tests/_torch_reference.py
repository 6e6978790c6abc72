"""Shared by the port's serving tests: the JAX package's reduced models
(qwen3-8b unless a run names another arch), their weights converted into
the port, and its ``ServeEngine`` run in a subprocess.

The reference engine runs with
``XLA_FLAGS=--xla_allow_excess_precision=false``: by default XLA:CPU keeps
bf16 intermediates in f32 under jit and skips the roundings the source
writes, while the port (like the reference run op by op) rounds where the
source casts; with the flag the jitted reference computes exactly its
source's arithmetic (test_torch_model.py shows the default-flag gap).  A
subprocess keeps the flag away from every other test in the worker.
"""
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np

from repro.configs import reduced_config as jreduced
from repro.models.transformer import LM as JLM
from repro_torch.convert import convert_params
from repro_torch.serve.request import Request
from repro_torch.spec import SamplingParams, SpecConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIERS = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
ENGINE_KW = dict(max_batch=4, max_len=64, decode_chunk=8)

# Runs the reference engine once per run of requests (a fresh engine each);
# prints the streams of every run and a checksum of the weights it served
# (the parent makes the same weights from the same key).
REFERENCE = r"""
import dataclasses, hashlib, json, sys
import jax, numpy as np
from repro.configs import reduced_config
from repro.core.policy import uniform_schedule
from repro.models.layers import Runtime
from repro.models.transformer import LM
from repro.serve.engine import Request, ServeEngine
from repro.serve.handle import RequestStatus
from repro.spec import SamplingParams, SpecConfig
spec = json.loads(sys.argv[1])
models, checksums = {}, {}


def model_of(arch, over):
    key = arch + (" " + json.dumps(over, sort_keys=True) if over else "")
    if key not in models:
        model = LM(dataclasses.replace(reduced_config(arch), **over))
        params = model.init(jax.random.PRNGKey(0))
        h = hashlib.sha1()
        for leaf in jax.tree.leaves(params):
            h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
        models[key], checksums[key] = (model, params), h.hexdigest()
    return models[key]


def runtime(kv_tiers):
    sched = uniform_schedule({t: tuple(b) for t, b in spec["tiers"].items()},
                             backend="decomposed", kv_tiers=kv_tiers)
    return Runtime(policy=sched.policy_for(), mode="serve", schedule=sched)


runs = []
for run in spec["runs"]:
    kw = dict(spec["engine"])
    arch, over, kv_tiers, migrate = "qwen3-8b", {}, None, []
    if isinstance(run, dict):
        kw.update(run.get("engine", {}))
        arch = run.get("arch", arch)
        over = run.get("cfg", over)
        kv_tiers = run.get("kv_tiers")
        migrate = list(run.get("migrate", []))
        run = run["requests"]
    model, params = model_of(arch, over)
    eng = ServeEngine(model, params, runtime(kv_tiers), packed=spec["packed"],
                      **kw)
    handles = [eng.submit(Request(
        uid=r["uid"], prompt=np.asarray(r["prompt"], np.int32),
        max_new_tokens=r["max_new"], tier=r["tier"],
        sampling=SamplingParams(*r["sampling"]) if r.get("sampling")
        else None,
        spec=SpecConfig(*r["spec"]) if r.get("spec") else None))
        for r in run]
    while eng.has_work:
        eng.step()
        for m in list(migrate):
            hd = handles[[h.uid for h in handles].index(m[0])]
            if hd.status is RequestStatus.RUNNING and len(hd.tokens) >= m[2]:
                hd.set_tier(m[1])
                migrate.remove(m)
    assert not migrate, migrate
    runs.append({str(h.uid): h.tokens for h in handles})
print(json.dumps({"checksums": checksums, "runs": runs}))
"""


def _checksum(params) -> str:
    h = hashlib.sha1()
    for leaf in jax.tree.leaves(params):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def reference_streams(engine_kw, specs, *, packed=False):
    """Greedy streams {uid: tokens} of the reference's mixed-tier
    ServeEngine (``TIERS``, decomposed backend) on reduced qwen3-8b with
    ``PRNGKey(0)`` weights, and the checksum of those weights."""
    runs, checksum = reference_runs(engine_kw, [specs], packed=packed)
    return runs[0], checksum


def reference_runs(engine_kw, runs, *, packed=False):
    """As :func:`reference_streams`, for several runs of request specs in
    one subprocess (a fresh engine per run).  A spec may carry
    ``"sampling": [temperature, top_k, seed]`` and ``"spec": [draft_tier,
    k]``; a run given as ``{"engine": kw, "requests": specs}`` overrides
    ``engine_kw`` with ``kw``, and may set ``"cfg"`` (overrides of the
    reduced config, e.g. ``{"num_kv_heads": 4}``: weights of their own,
    checksummed under ``"<arch> <json of cfg>"``), ``"kv_tiers"`` (the
    schedule's) and ``"migrate"`` (``[uid, tier, after n tokens]``: applied
    after every step to a RUNNING request that has emitted enough).
    Returns ([{uid: tokens} per run], weights checksum)."""
    out, checksums = reference_arch_runs(engine_kw, runs, packed=packed)
    return out, checksums["qwen3-8b"]


def reference_arch_runs(engine_kw, runs, *, packed=False):
    """As :func:`reference_runs`, where a run given as a dict may also name
    its reduced ``"arch"`` (default qwen3-8b, ``PRNGKey(0)`` weights).
    Returns ([{uid: tokens} per run], {arch: weights checksum})."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    spec = {"engine": engine_kw, "runs": runs, "tiers": TIERS,
            "packed": packed}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(spec)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    return ([{int(k): v for k, v in run.items()} for run in ref["runs"]],
            ref["checksums"])


def reference_weights(arch="qwen3-8b", **cfg):
    """(reference model, its PRNGKey(0) params, checksum, the params
    converted into the port on the CPU) of reduced ``arch`` (with the
    config overrides ``cfg``)."""
    jm = JLM(dataclasses.replace(jreduced(arch), **cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, _checksum(jp), convert_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def request_specs():
    """Nine requests round-robin over ``TIERS``, as JSON-able dicts."""
    rng = np.random.default_rng(1)
    return [{"uid": i,
             "prompt": rng.integers(0, 512, size=4 + (i * 3) % 11).tolist(),
             "max_new": 1 + (i * 5) % 12, "tier": list(TIERS)[i % 3]}
            for i in range(9)]


def to_requests(specs, tiered=True):
    """The port's Requests for ``specs`` (tier-less unless ``tiered``),
    with their ``sampling`` and ``spec`` where a spec sets them."""
    return [Request(uid=s["uid"], prompt=np.asarray(s["prompt"], np.int32),
                    max_new_tokens=s["max_new"],
                    tier=s["tier"] if tiered else None,
                    sampling=SamplingParams(*s["sampling"])
                    if s.get("sampling") else None,
                    spec=SpecConfig(*s["spec"]) if s.get("spec") else None)
            for s in specs]
