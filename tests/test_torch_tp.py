"""repro_torch tensor-parallel serving (``ServeEngine(mesh=)`` over
``torch.distributed``) held against the JAX package.

In process: the bit-serial wire format and its accounting
(``wire_pack``/``wire_unpack``, ``wire_bytes_per_element``,
``decode_wire_stats``), the serve sharding rules leaf by leaf against the
reference's ``PartitionSpec``\\ s over the prepared store and the arena,
``TPConfig.gathers``, and each rank's attention (its heads computed among
zero heads at the whole head count) against the unsharded call.

Across ranks: ONE spawn of four gloo CPU ranks for the module
(``launch.mesh.spawn_ranks``; 2-rank runs on a subgroup), whose side is
tests/_torch_tp_ranks.py: the shared-range quantizers (their shards
concatenate to the reference's unsharded codes and scales), the gathered
matmuls (equal to the port's unsharded ``ops`` calls), and the mesh engine
on the reference test's scenario (reduced qwen3-8b with ``num_kv_heads=4``,
five requests over three tiers, KV tiers, one migration) at n = 2 and 4 on
both stores and under MQA at n = 2, whose streams must equal the unsharded
port engine's and the reference engine's (its one subprocess,
``_torch_reference.reference_arch_runs``); preemption and resume on a mesh,
sampling at mesh widths 1 and 2, a profiled telemetry, the bytes counted on
the wire against ``decode_wire_stats``, and the construction errors.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from _torch_reference import reference_arch_runs, reference_weights
from repro.configs import reduced_config as jreduced
from repro.core.policy import LayerPrecision as JLayerPrecision
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.distributed import sharding_rules as jrules
from repro.distributed import tp_serve as jtp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import LM as JLM
from repro.serve import slots as jslots
from repro.serve.engine import prepare_params as jprepare
from repro_torch.configs import reduced_config
from repro_torch.core.policy import LayerPrecision, uniform_schedule
from repro_torch.distributed import sharding_rules, tp_serve
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers
from repro_torch.models.transformer import LM
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.engine import prepare_params

QWEN, JAMBA = "qwen3-8b", "jamba-1.5-large-398b"
KV4 = {"num_kv_heads": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- wire format (host)
@pytest.mark.parametrize("bits", [2, 4])
def test_wire_pack_equals_reference(bits):
    rng = np.random.default_rng(0)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    q = rng.integers(lo, hi + 1, size=(3, 64)).astype(np.int8)
    p = tp_serve.wire_pack(torch.from_numpy(q), bits)
    assert p.dtype == torch.uint8 and tuple(p.shape) == (3, 64 * bits // 8)
    assert np.array_equal(p.numpy(),
                          np.asarray(jtp.wire_pack(jnp.asarray(q), bits)))
    assert np.array_equal(tp_serve.wire_unpack(p, bits).numpy(), q)


@pytest.mark.parametrize("bits", [2, 4])
def test_wire_pack_commutes_with_tiled_gather(bits):
    rng = np.random.default_rng(1)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    shards = [torch.from_numpy(rng.integers(lo, hi + 1, size=(2, 32))
                               .astype(np.int8)) for _ in range(4)]
    packed = torch.cat([tp_serve.wire_pack(s, bits) for s in shards], -1)
    assert torch.equal(tp_serve.wire_unpack(packed, bits),
                       torch.cat(shards, -1))


def test_wire_bytes_per_element():
    for bits in range(2, 9):
        for signed in (True, False):
            assert tp_serve.wire_bytes_per_element(bits, signed) == \
                jtp.wire_bytes_per_element(bits, signed)
    assert tp_serve.wire_bytes_per_element(4) == 0.5
    assert tp_serve.wire_bytes_per_element(2) == 0.25


@pytest.mark.parametrize("arch", [QWEN, JAMBA])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("groups", [((4, 8),), ((4, 4),), ((4, 2),),
                                    ((2, 8), (1, 4), (1, 2)),
                                    ((3, 6), (5, 2))])
def test_decode_wire_stats_equal_reference(arch, n, groups):
    got = tp_serve.decode_wire_stats(reduced_config(arch),
                                     tp_serve.TPConfig(n=n), groups)
    want = jtp.decode_wire_stats(jreduced(arch), jtp.TPConfig(n=n), groups)
    assert got == want


def test_tp_config_gathers():
    tp = tp_serve.TPConfig(n=2)
    assert tp.gathers("layers.pos0.attn.o_proj")
    assert tp.gathers("layers.pos1.mlp.down_proj")
    for name in ("layers.pos0.attn.q_proj", "layers.pos0.mlp.up_proj",
                 "layers.pos1.moe.down_proj", "layers.pos0.mamba.out_proj",
                 "lm_head"):
        assert not tp.gathers(name)
        assert tp.gathers(name) == jtp.TPConfig(n=2).gathers(name)


@pytest.mark.parametrize("kvh", [4, 1])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kv_bits", [None, 8, (16, 8, 4)])
def test_rank_attention_equals_its_heads_of_the_whole(kvh, n, kv_bits):
    """Each rank's decode and prefill attention (its heads, its KV heads or
    the one replicated MQA head, its ``TPConfig``) equals the same heads
    of the unsharded call, bit for bit."""
    gen = torch.Generator().manual_seed(11)
    b, s, h, dh = 3, 24, 8, 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    def heads(t, r):
        return t.narrow(2, r * t.shape[2] // n, t.shape[2] // n)

    def tp(r):
        return tp_serve.TPConfig(n=n, rank=r, kv_shards=kvh > 1)
    cache = layers.KVCache.create(b, s, kvh, dh, kv_bits=kv_bits)
    if cache.mixed:
        cache.kv_bits.copy_(torch.tensor([16, 8, 4], dtype=torch.int32))
    cache.update(rnd(b, s, kvh, dh), rnd(b, s, kvh, dh), 0,
                 new_length=torch.tensor([5, 24, 13], dtype=torch.int32))
    q = rnd(b, 1, h, dh)
    parts = []
    for r in range(n):
        sub = cache if kvh == 1 else layers.KVCache(*[
            None if t is None else heads(t, r) if t.ndim == 4 else t
            for t in (cache.k, cache.v, cache.k_scale, cache.v_scale,
                      cache.length, cache.kv_bits)], modes=cache.modes)
        parts.append(layers.decode_attention(heads(q, r).contiguous(), sub,
                                             tp=tp(r)))
    assert torch.equal(torch.cat(parts, 2), layers.decode_attention(q, cache))
    q, k, v = rnd(b, 16, h, dh), rnd(b, s, kvh, dh), rnd(b, s, kvh, dh)
    whole = layers.flash_attention(q, k, v, causal=True, block_k=16,
                                   q_offset=s - 16)
    parts = [layers.flash_attention(
        heads(q, r).contiguous(),
        *(t if kvh == 1 else heads(t, r).contiguous() for t in (k, v)),
        causal=True, block_k=16, q_offset=s - 16, tp=tp(r))
        for r in range(n)]
    assert torch.equal(torch.cat(parts, 2), whole)


def test_fused_decode_linear_pre_quant():
    """``pre_quant`` skips the quantization and nothing else."""
    gen = torch.Generator().manual_seed(5)
    qw = ops.prepare_superplane(torch.randn((32, 24), generator=gen))
    x = torch.randn((5, 32), generator=gen).to(torch.bfloat16)
    groups = ((2, LayerPrecision(8, 8, backend="decomposed")),
              (3, LayerPrecision(2, 2, backend="decomposed")))
    perm = torch.tensor([3, 0, 4, 1, 2])
    pre = ops.quantize_activations_grouped(x, groups, perm)
    assert torch.equal(
        ops.fused_decode_linear(x, qw, groups, perm, pre_quant=pre),
        ops.fused_decode_linear(x, qw, groups, perm))


# ------------------------------------------------------------- spec rules
# Dataclass fields, which a keystr names as attributes.
_ATTRS = ("planes", "packed", "scale", "k", "v", "k_scale", "v_scale",
          "length", "kv_bits", "conv", "state")


def _ref_key(port_path):
    """The reference's keystr of a port path (its periods are stacked:
    the list index goes)."""
    parts = [{"layers": "periods"}.get(p, p) for p in port_path.split(".")
             if not p.isdigit()]
    if parts[-1] not in _ATTRS:
        return "".join(f"[{p!r}]" for p in parts)
    return "".join(f"[{p!r}]" for p in parts[:-1]) + f".{parts[-1]}"


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(kp): spec for kp, spec in flat}


def _check_specs(port_tree, port_specs, ref_tree, ref_specs):
    """Each port leaf shards the axis the reference's PartitionSpec names
    on the stacked leaf (one period axis more), or neither shards."""
    ref_leaves = dict(zip(ref_specs, jax.tree.leaves(ref_tree)))
    port_leaves = {}
    sharding_rules._map_leaves(
        port_tree, lambda p, t: port_leaves.setdefault(p, t))
    assert set(port_specs) == set(port_leaves)
    checked = 0
    for path, dim in port_specs.items():
        key = _ref_key(path)
        spec, leaf = ref_specs[key], ref_leaves[key]
        axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
        if dim is None:
            assert axes == [], (path, spec)
            continue
        offset = leaf.ndim - port_leaves[path].ndim
        assert axes == [dim + offset], (path, dim, spec)
        checked += 1
    return checked


@pytest.fixture(scope="module")
def stores():
    """Reduced qwen3-8b (KV heads 4 and 1) and jamba, prepared as the
    superplane store in both packages, planes and packed (the reference's
    as shapes: ``jax.eval_shape``)."""
    out = {}
    for arch, over in ((QWEN, KV4), (QWEN, {}), (JAMBA, {})):
        cfg = dataclasses.replace(reduced_config(arch), **over)
        jcfg = dataclasses.replace(jreduced(arch), **over)
        jm = JLM(jcfg)
        jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        model = LM(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        jsched = juniform_schedule({"8/8": (8, 8)})
        sched = uniform_schedule({"8/8": (8, 8)}, backend="decomposed")
        for packed in (False, True):
            out[(arch, bool(over), packed)] = (
                cfg, prepare_params(params, sched.prepare_policy(), model,
                                    packed=packed, superplane=True)[0],
                jax.eval_shape(lambda p: jprepare(
                    p, jsched.prepare_policy(), jm, packed=packed,
                    superplane=True)[0], jp))
        out[(arch, bool(over), "models")] = (model, jm)
    return out


@pytest.mark.parametrize("arch,kv4", [(QWEN, True), (QWEN, False),
                                      (JAMBA, False)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_param_specs_equal_reference(stores, arch, kv4, packed, n):
    cfg, tree, jtree = stores[(arch, kv4, packed)]
    if cfg.num_heads % n:
        pytest.skip("heads do not divide")
    kv_shards = cfg.num_kv_heads % n == 0
    specs = sharding_rules.serve_tp_param_specs(tree, n=n,
                                                kv_shards=kv_shards)
    jspecs = _ref_specs(jrules.serve_tp_param_specs(
        jtree, n=n, kv_shards=kv_shards))
    assert _check_specs(tree, specs, jtree, jspecs) > 0


@pytest.mark.parametrize("kv_bits", [None, 8, 4, (16, 8, 4)])
@pytest.mark.parametrize("arch,kv4,n", [(QWEN, True, 2), (QWEN, True, 4),
                                        (QWEN, False, 2), (JAMBA, False, 2)])
def test_cache_specs_equal_reference(stores, kv_bits, arch, kv4, n):
    model, jm = stores[(arch, kv4, "models")]
    kv_shards = model.cfg.num_kv_heads % n == 0
    caches = slots_lib.SlotArena(model, 2, 16, kv_bits=kv_bits,
                                 device="cpu").caches
    jcaches = jslots.SlotArena(jm, 2, 16, kv_bits=kv_bits).caches
    specs = sharding_rules.serve_tp_cache_specs(caches, n=n,
                                                kv_shards=kv_shards)
    jspecs = _ref_specs(jrules.serve_tp_cache_specs(
        jcaches, n=n, kv_shards=kv_shards))
    checked = _check_specs(caches, specs, jcaches, jspecs)
    fields = 2 if kv_bits is None else 4          # k, v (and scales)
    assert checked == (fields * sum(m == "attn" for m, _ in model.pattern)
                       * model.cfg.n_periods if kv_shards else 0)


def test_spec_errors_equal_reference(stores):
    cfg, tree, jtree = stores[(QWEN, True, False)]
    path = "layers.0.pos0.attn.q_proj.w.planes"
    leaf = tree["layers"][0]["pos0"]["attn"]["q_proj"]["w"].planes
    jleaf = jtree["periods"]["pos0"]["attn"]["q_proj"]["w"].planes
    with pytest.raises(ValueError) as got:
        sharding_rules.serve_tp_param_spec(path, leaf, n=3, kv_shards=True)
    with pytest.raises(ValueError) as want:
        jrules.serve_tp_param_spec(_ref_key(path), jleaf, n=3,
                                   kv_shards=True)
    assert str(got.value).split(path)[1] == \
        str(want.value).split(_ref_key(path))[1]
    k = torch.zeros((2, 8, 4, 16))
    with pytest.raises(ValueError, match="KV-head axis 4 does not divide "
                                         "across 3 devices"):
        sharding_rules.serve_tp_cache_spec("0.pos0.k", k, n=3,
                                           kv_shards=True)
    with pytest.raises(ValueError, match="KV-head axis 4 does not divide "
                                         "across 3 devices"):
        jrules.serve_tp_cache_spec("['pos0'].k", jnp.zeros((1, 2, 8, 4, 16)),
                                   n=3, kv_shards=True)


def test_make_serve_mesh_needs_a_group():
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        mesh_lib.make_serve_mesh(2, device="cpu")


# ------------------------------------------------------------ across ranks
@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference engine's runs of the scenario (KV heads 4, then MQA):
    one subprocess, started with the module's first test and read by
    :func:`mesh_runs`.  Returns (thread, results)."""
    specs = ranks.request_specs(reduced_config(QWEN).vocab_size)
    run = {"kv_tiers": ranks.KV_TIERS, "migrate": ranks.MIGRATE,
           "requests": specs}
    ref = {}
    thread = threading.Thread(target=lambda: ref.update(zip(
        ("runs", "sums"), reference_arch_runs(ranks.ENGINE_KW, [
            dict(run, cfg=KV4), run]))))
    thread.start()
    yield thread, ref
    thread.join()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, reference):
    """The four ranks' results, the unsharded port engine's runs and the
    reference engine's."""
    d = tmp_path_factory.mktemp("tp")
    _, _, sum4, p4 = reference_weights(**KV4)
    _, _, summ, pm = reference_weights()
    cfg4 = dataclasses.replace(reduced_config(QWEN), **KV4)
    cfgm = reduced_config(QWEN)
    cfg2 = dataclasses.replace(cfgm, num_kv_heads=2)
    p2 = LM(cfg2).init(torch.Generator().manual_seed(0), device="cpu")
    files = {}
    for label, cfg, params in (("kv4", cfg4, p4), ("mqa", cfgm, pm),
                               ("kv2", cfg2, p2)):
        files[label] = str(d / f"{label}.pt")
        torch.save((cfg, params), files[label])
    try:
        per_rank = mesh_lib.spawn_ranks(4, ranks.run_all, files,
                                        str(d / "spill"), device="cpu")
    finally:
        thread, ref = reference
        thread.join()
    assert ref["sums"][f"{QWEN} {{\"num_kv_heads\": 4}}"] == sum4
    assert ref["sums"][QWEN] == summ
    m4, mm = LM(cfg4), LM(cfgm)
    plain = {}
    for packed in (False, True):
        plain[("serve", packed)] = ranks.serve(
            m4, p4, backend="cuda", packed=packed, migrate=ranks.MIGRATE)[0]
    plain["mqa"] = ranks.serve(mm, pm, migrate=ranks.MIGRATE)[0]
    plain["greedy"] = ranks.serve(m4, p4)[0]
    plain["preempt"] = ranks.serve(m4, p4, preempt=(0, 1))
    plain["sampled"] = ranks.serve(m4, p4, sampled=True)[0]
    return {"ranks": per_rank, "ref": ref["runs"], "plain": plain,
            "cfg": cfg4}


@pytest.mark.parametrize("n", [4, 2])
def test_act_quant_pmax_equals_reference(mesh_runs, n):
    """The shared-range quantizers' shards concatenate to the reference's
    unsharded codes, with its scales on every rank, bit for bit."""
    outs = [r[("quant", n)] for r in mesh_runs["ranks"][:n]]
    x = outs[0]["x"]
    for bits in ranks.QUANT_BITS:
        q, s = jref.act_quant_ref(jnp.asarray(x), bits=bits)
        assert np.array_equal(np.concatenate([o[bits][0] for o in outs], -1),
                              np.asarray(q))
        for o in outs:
            assert np.array_equal(o[bits][1], np.asarray(s))
    groups = tuple((r, JLayerPrecision(w, a, backend="decomposed"))
                   for r, (w, a) in ranks.ROW_GROUPS)
    q, s = jops._quantize_activations_rows(
        jnp.asarray(x), groups, jnp.asarray(ranks.ROW_PERM, jnp.int32),
        use_pallas=False)
    assert np.array_equal(np.concatenate([o["rows"][0] for o in outs], -1),
                          np.asarray(q))
    for o in outs:
        assert np.array_equal(o["rows"][1], np.asarray(s))


@pytest.mark.parametrize("n", [4, 2])
def test_gathered_matmuls_equal_unsharded(mesh_runs, n):
    for r in mesh_runs["ranks"][:n]:
        eq = r[("gemm", n)]
        assert len(eq) == 16 and all(eq.values()), eq


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_mesh_streams_equal_unsharded_and_reference(mesh_runs, n, packed):
    want = mesh_runs["plain"][("serve", packed)]
    assert want == mesh_runs["ref"][0]
    for r in mesh_runs["ranks"][:n]:
        streams, kv_migrations, kv_shards = r[("serve", n, packed)]
        assert streams == want
        assert kv_migrations == 1 and kv_shards


def test_mqa_mesh_streams_equal_unsharded_and_reference(mesh_runs):
    want = mesh_runs["plain"]["mqa"]
    assert want == mesh_runs["ref"][1]
    for r in mesh_runs["ranks"][:2]:
        assert r["mqa"] == (want, False)        # the KV head replicated


@pytest.mark.parametrize("where", ["memory", "spill"])
def test_mesh_preempt_resume(mesh_runs, where):
    """Preempting uids 0 and 1 on a 2-rank mesh resumes them token-
    identically; the host snapshot holds the unsharded engine's bytes and
    the spill directory ends empty."""
    want = mesh_runs["plain"]["greedy"]
    streams, _, snaps = mesh_runs["plain"]["preempt"]
    assert streams == want
    for r in mesh_runs["ranks"][:2]:
        got, resumes, got_snaps = r[("preempt", where)]
        assert got == want and resumes == 2
        if where == "memory":
            for uid in (0, 1):
                for a, b in zip(got_snaps[uid], snaps[uid]):
                    for pos in b:
                        for f in b[pos]:
                            assert np.array_equal(a[pos][f], b[pos][f])
        else:
            assert got_snaps == {0: None, 1: None}
            assert r["spill_left"] == []


def test_sampled_streams_across_mesh_widths(mesh_runs):
    want = mesh_runs["plain"]["sampled"]
    assert mesh_runs["ranks"][0][("sampled", 1)] == want
    for r in mesh_runs["ranks"][:2]:
        assert r[("sampled", 2)] == want


def test_mesh_telemetry(mesh_runs):
    """Profiled telemetry on a mesh leaves the streams equal; rank 0
    records, the other ranks hold none."""
    want = mesh_runs["plain"]["greedy"]
    r0, r1 = (r["telemetry"] for r in mesh_runs["ranks"][:2])
    streams, none, steps, chunks, reg_steps, calls = r0
    assert streams == want and not none
    assert reg_steps == float(steps) and calls == chunks
    assert r1[0] == want and r1[1]


@pytest.mark.parametrize("n", [4, 2])
def test_wire_bytes_equal_decode_wire_stats(mesh_runs, n):
    cfg = mesh_runs["cfg"]
    a_bits = {t: wa[1] for t, wa in ranks.TIERS.items()}
    for r in mesh_runs["ranks"][:n]:
        layouts = r[("wire", n)]
        assert len({g for g, _, _ in layouts}) == 3
        for groups, counted, standins in layouts:
            g = tuple((rows, a_bits[t]) for t, rows in groups)
            stats = jtp.decode_wire_stats(jreduced(QWEN), jtp.TPConfig(n=n), g)
            assert counted["codes"] == stats["quant_gather_bytes"]
            assert counted["outputs"] == stats["out_gather_bytes"]
            assert standins == 0                        # CPU: no launches
            assert stats == tp_serve.decode_wire_stats(
                cfg, tp_serve.TPConfig(n=n), g)


def test_mesh_construction_errors(mesh_runs):
    errs = mesh_runs["ranks"][0]["errors"]
    assert errs["heads"] == ("serve TP: num_heads=4 does not divide across "
                             "3 devices")
    assert errs["kv_heads"] == ("serve TP: num_kv_heads=2 neither divides "
                                "across 4 devices nor is 1 (the "
                                "replicated-MQA fallback)")
    assert errs["store"] == ("serve TP shards the prepared plane store; a "
                             "mesh needs an integer backend")
    assert errs["spec"].startswith("request 0: speculative decoding is not "
                                   "supported on a mesh engine")
    assert mesh_runs["ranks"][3]["errors"] == {"kv_heads": errs["kv_heads"]}


@pytest.mark.parametrize("devices, backend", [
    (["cuda:0", "cuda:0"], "gloo"),          # ranks sharing one card
    (["cuda:0", "cuda:1"], "nccl"),          # a card for each rank
    (["cuda:0", "cuda:1", "cuda:1"], "gloo"),
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cpu"], "gloo"),
])
def test_backend_follows_the_ranks_devices(devices, backend):
    assert mesh_lib._backend_for(devices) == backend


def test_spawn_ranks_fails_with_a_rank():
    with pytest.raises(mesh_lib.RankError, match="rank 0 stops here"):
        mesh_lib.spawn_ranks(1, ranks.fail, device="cpu")


CLI = ["--reduced", "--device", "cpu", "--backend", "decomposed", "--tiers",
       "8/8", "4/4", "2/2", "--kv-tiers", "bf16", "8", "4", "--requests", "5",
       "--max-new", "6", "--decode-chunk", "2", "--migrate-demo"]


def test_cli_mesh_equals_unsharded(capfd):
    """``--mesh 2`` on the CPU: two ranks, rank 0 reports, the streams
    equal the unsharded command line's."""
    want = serve_cli.main(CLI)
    capfd.readouterr()
    got = serve_cli.main(CLI + ["--mesh", "2"])
    out = capfd.readouterr().out
    assert got == want
    assert "mesh 2 ranks (gloo, cpu)" in out and "migrated uid=" in out


@pytest.mark.parametrize("extra,msg", [
    (["--baseline"], "--mesh needs the continuous-batching engine"),
    (["--backend", "dense"], "--mesh shards the quantized plane store"),
    (["--tiers", "8/8", "2/2", "--speculate"],
     "--speculate is not supported on a mesh engine"),
])
def test_cli_mesh_errors(capsys, extra, msg):
    with pytest.raises(SystemExit):
        serve_cli.main(["--reduced", "--device", "cpu", "--mesh", "2"]
                       + extra)
    assert msg in capsys.readouterr().err
