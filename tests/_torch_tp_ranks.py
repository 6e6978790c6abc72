"""The rank side of tests/test_torch_tp.py: what each of the module's four
gloo CPU ranks runs (``launch.mesh.spawn_ranks``).  It imports torch and
the port only, so the spawned ranks start without jax; the module holds
the results against the JAX package.

Every rank runs :func:`run_all` in the same order: each mesh is made by
every rank (``make_serve_mesh`` is collective), and ranks off a smaller
mesh skip its runs.  Results are plain Python and numpy.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.policy import (LayerPrecision, uniform_policy,
                                     uniform_schedule)
from repro_torch.distributed import tp_serve
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.handle import RequestStatus
from repro_torch.serve.request import Request
from repro_torch.spec import SamplingParams, SpecConfig
from repro_torch.telemetry import Telemetry

TIERS = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}
ENGINE_KW = dict(max_batch=4, max_len=64, decode_chunk=4)
# The reference test's migration, made explicit: uid 0 (8/8) moves to 2/2
# once it has two tokens.
MIGRATE = [[0, "2/2", 2]]
QUANT_BITS = (2, 3, 4, 5, 6, 7, 8)
QUANT_SHAPE = (6, 64)
# (rows, (w_bits, a_bits)) per group, and the slot order of the batch.
ROW_GROUPS = ((3, (8, 8)), (2, (4, 4)), (1, (2, 2)))
ROW_PERM = (4, 0, 5, 2, 1, 3)
GEMM_KN = (64, 96)


def requests(vocab, n=5, sampled=False):
    """The reference test's five requests (prompts of 4, budgets of 10,
    tiers round-robin), sampled at temperature 0.8, top-k 12 if asked."""
    rng = np.random.default_rng(0)
    tiers = list(TIERS)
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=4).astype(
                        np.int32),
                    max_new_tokens=10, tier=tiers[i % 3],
                    sampling=SamplingParams(0.8, 12, 100 + i) if sampled
                    else None)
            for i in range(n)]


def request_specs(vocab):
    """:func:`requests` as the reference subprocess's JSON specs."""
    return [{"uid": r.uid, "prompt": r.prompt.tolist(),
             "max_new": r.max_new_tokens, "tier": r.tier}
            for r in requests(vocab)]


def runtime(backend="decomposed", kv_tiers=KV_TIERS):
    sched = uniform_schedule(TIERS, backend=backend, kv_tiers=kv_tiers)
    return Runtime(policy=sched.policy_for(), schedule=sched)


def _host(t):
    """A CPU tensor as numpy (bf16 through its int16 bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def serve(model, params, *, mesh=None, backend="decomposed", packed=False,
          migrate=(), preempt=(), spill_dir=None, sampled=False,
          telemetry=None, kv_tiers=KV_TIERS, device="cpu"):
    """Serve :func:`requests` step by step, applying ``migrate`` and
    preempting the uids of ``preempt`` after the first round.  Returns
    (streams, engine, snapshots of the preempted uids)."""
    eng = ServeEngine(model, params, runtime(backend, kv_tiers),
                      packed=packed, mesh=mesh, spill_dir=spill_dir,
                      telemetry=telemetry, device=device, **ENGINE_KW)
    handles = {r.uid: eng.submit(r)
               for r in requests(model.cfg.vocab_size, sampled=sampled)}
    pending, snaps, rounds = [list(m) for m in migrate], {}, 0
    while eng.has_work:
        eng.step()
        rounds += 1
        if rounds == 1:
            for uid in preempt:
                sus = eng.preempt(uid)
                snaps[uid] = None if sus.cache is None else [
                    {pos: {f: _host(t) for f, t in fields.items()}
                     for pos, fields in layer.items()} for layer in sus.cache]
        for m in list(pending):
            hd = handles[m[0]]
            if hd.status is RequestStatus.RUNNING and len(hd.tokens) >= m[2]:
                hd.set_tier(m[1])
                pending.remove(m)
    assert not pending
    return {u: h.tokens for u, h in handles.items()}, eng, snaps


def _shard_cols(qw, rank, n):
    def cut(t):
        if t is None:
            return None
        step = t.shape[-1] // n
        return t[..., rank * step:(rank + 1) * step].contiguous()
    return dataclasses.replace(qw, planes=cut(qw.planes),
                               packed=cut(qw.packed), scale=cut(qw.scale))


def _quant(rank, mesh):
    """Each rank's K-shard of the shared-range quantizers' codes and the
    scales, at every width and for the per-row-range form."""
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(QUANT_SHAPE, generator=gen) * 3).to(torch.bfloat16)
    x[1] = 0.0                                     # an all-zero row
    k = x.shape[-1] // mesh.n
    xs = x[:, rank * k:(rank + 1) * k]
    out = {"x": x.float().numpy()}
    for bits in QUANT_BITS:
        q, s = tp_serve._act_quant_pmax(xs, bits, mesh.group)
        out[bits] = (q.numpy(), s.numpy())
    groups = tuple((r, LayerPrecision(w, a, backend="decomposed"))
                   for r, (w, a) in ROW_GROUPS)
    q, s = tp_serve._act_quant_rows_pmax(xs, groups, torch.tensor(ROW_PERM),
                                         mesh.group)
    out["rows"] = (q.numpy(), s.numpy())
    return out


def _gemms(rank, mesh):
    """gathered_matmul and gathered_grouped_matmul against the port's
    unsharded ops call, bit for bit, on both stores."""
    gen = torch.Generator().manual_seed(3)
    kk, nn = GEMM_KN
    w = torch.randn((kk, nn), generator=gen)
    x = torch.randn((len(ROW_PERM), kk), generator=gen).to(torch.bfloat16)
    k = kk // mesh.n
    xs = x[:, rank * k:(rank + 1) * k]
    tp = tp_serve.TPConfig(n=mesh.n, rank=mesh.rank, group=mesh.group)
    perm = torch.tensor(ROW_PERM)
    equal = {}
    for packed in (False, True):
        qw = ops.prepare_superplane(w, packed=packed)
        qs = _shard_cols(qw, rank, mesh.n)
        for backend in ("decomposed", "cuda"):
            for wa in TIERS.values():
                prec = LayerPrecision(*wa, backend=backend)
                want = ops.matmul(x, None, prec, qw=qw)
                got = tp_serve.gathered_matmul(xs, qs, prec, tp=tp)
                equal[("one", packed, backend, wa)] = torch.equal(got, want)
            groups = tuple((r, LayerPrecision(w_, a_, backend=backend))
                           for r, (w_, a_) in ROW_GROUPS)
            want = ops.matmul(x, None, groups[0][1], qw=qw,
                              row_groups=groups, perm=perm)
            got = tp_serve.gathered_grouped_matmul(xs, qs, groups, perm,
                                                   tp=tp)
            equal[("grouped", packed, backend)] = torch.equal(got, want)
    return equal


def _wire(model, params, mesh):
    """Code and output bytes of one decode step at each layout of a
    four-request mixed batch, as counted on the wire."""
    eng = ServeEngine(model, params, runtime(kv_tiers=None), mesh=mesh,
                      device="cpu", **ENGINE_KW)
    for r in requests(model.cfg.vocab_size, n=4):
        eng.submit(r)
    eng._admit_free_slots()
    out = []
    for tiers in (None, ["2/2", "2/2", "8/8", "4/4"], ["4/4"] * 4):
        groups, _ = eng._group_layout(tiers)
        tp_serve.reset_wire_bytes()
        standins = tp_serve.STANDIN_QUANTS["act_quant"]
        eng.decode_dispatch_count(groups=groups)
        out.append((groups, dict(tp_serve.WIRE_BYTES),
                    tp_serve.STANDIN_QUANTS["act_quant"] - standins))
    return out


def _errors(rank, models):
    """The construction errors and the speculation refusal, as messages."""
    out = {}
    mesh3 = make_serve_mesh(3, device="cpu")
    mesh4 = make_serve_mesh(4, device="cpu")
    mesh2 = make_serve_mesh(2, device="cpu")
    dense = Runtime(policy=uniform_policy(8, 8, backend="dense"))
    cases = [("heads", models["kv4"], mesh3, runtime()),
             ("kv_heads", models["kv2"], mesh4, runtime()),
             ("store", models["kv4"], mesh2, dense)]
    for label, (model, params), mesh, rt in cases:
        if not mesh.member:
            continue
        try:
            ServeEngine(model, params, rt, mesh=mesh, device="cpu",
                        **ENGINE_KW)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    if mesh2.member:
        model, params = models["kv4"]
        eng = ServeEngine(model, params, runtime(), mesh=mesh2, device="cpu",
                          **ENGINE_KW)
        req = dataclasses.replace(requests(model.cfg.vocab_size, n=1)[0],
                                  spec=SpecConfig("2/2", 2))
        try:
            eng.submit(req)
            out["spec"] = None
        except ValueError as e:
            out["spec"] = str(e)
    return out


def gpu_rank(rank, path):
    """tests/test_torch_gpu.py's rank: the saved (config, params) served on
    a 2-rank mesh sharing the card, the ``cuda`` backend."""
    cfg, params = torch.load(path, weights_only=False, map_location="cuda")
    mesh = make_serve_mesh(2, device="cuda")
    return serve(LM(cfg), params, mesh=mesh, backend="cuda", migrate=MIGRATE,
                 device="cuda")[0]


def fail(rank):
    """A rank that raises (``spawn_ranks`` must fail with it)."""
    raise RuntimeError(f"rank {rank} stops here")


def run_all(rank, files, spill):
    """Every mesh scenario of the module on this rank; ``files`` maps a
    model label to a ``torch.save`` of (config, params), ``spill`` is the
    (empty) spill directory every rank shares."""
    models = {}
    for label, path in files.items():
        cfg, params = torch.load(path, weights_only=False)
        models[label] = (LM(cfg), params)
    out = {}
    for n in (4, 2):
        mesh = make_serve_mesh(n, device="cpu")
        if mesh.member:
            out[("quant", n)] = _quant(rank, mesh)
            out[("gemm", n)] = _gemms(rank, mesh)
    model, params = models["kv4"]
    for n in (4, 2):
        mesh = make_serve_mesh(n, device="cpu")
        if not mesh.member:
            continue
        for packed in (False, True):
            streams, eng, _ = serve(model, params, mesh=mesh, backend="cuda",
                                    packed=packed, migrate=MIGRATE)
            out[("serve", n, packed)] = (streams, eng.stats.kv_migrations,
                                         eng._tp.kv_shards)
        out[("wire", n)] = _wire(model, params, mesh)
    mesh = make_serve_mesh(2, device="cpu")
    if mesh.member:
        mqa, mqa_params = models["mqa"]
        streams, eng, _ = serve(mqa, mqa_params, mesh=mesh, migrate=MIGRATE)
        out["mqa"] = (streams, eng._tp.kv_shards)
        for label, kw in (("memory", {}), ("spill", {"spill_dir": spill})):
            streams, eng, snaps = serve(model, params, mesh=mesh,
                                        preempt=(0, 1), **kw)
            out[("preempt", label)] = (streams, eng.stats.resumes, snaps)
        out["spill_left"] = sorted(os.listdir(spill))
        tele = Telemetry(profile=True)
        streams, eng, _ = serve(model, params, mesh=mesh, telemetry=tele)
        out["telemetry"] = (
            streams, eng.telemetry is None, eng.stats.decode_steps,
            eng.stats.decode_chunks,
            tele.registry.value("serve_decode_steps"),
            tele.profiler.snapshot()["phases"]["decode_chunk"]["calls"]
            if tele.profiler.snapshot()["phases"] else None)
    for n in (1, 2):
        mesh = make_serve_mesh(n, device="cpu")
        if mesh.member:
            out[("sampled", n)] = serve(model, params, mesh=mesh,
                                        sampled=True)[0]
    out["errors"] = _errors(rank, models)
    return out
