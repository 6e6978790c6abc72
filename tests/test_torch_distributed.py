"""repro_torch's distributed training blocks held against the JAX package:
the training meshes (``launch.mesh.make_mesh`` / ``make_production_mesh``),
the logical axes (``distributed.sharding``), the FSDP x TP rules
(``distributed.sharding_rules``), the quantized TP MLP block
(``tp_matmul``), compressed data-parallel gradients (``compression``) and
the GPipe pipeline (``pipeline``).

In process: every rule against the reference's, leaf for leaf, on
``jax.sharding.AbstractMesh`` meshes (the rules read only shape and axis
names): the ten archs' full configs (shapes only: the port's trees on the
meta device, the reference's from ``jax.eval_shape``), their AdamW state
and their prepared superplane stores, and the caches and batches at the
dry-run shapes' batch sizes.

Across ranks: ONE spawn of four gloo CPU ranks (tests/_torch_dist_ranks.py)
and, beside it, ONE JAX subprocess with 512 fake CPU devices (for the
production meshes; the runs use the first 2 or 4) and
``--xla_allow_excess_precision=false``, so that jitted XLA rounds bf16
where its source casts, as the port does.  Both read the same numpy
inputs.  The ranks run the TP MLP block at n = 2 and 4, compressed psums
at bits 8 and 2, 20 rounds of error feedback, the pipeline, the rules'
blocks of a train state, and a train-state checkpoint written by the
reference's ``checkpoint.save`` restored onto two meshes.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.distributed import sharding as jsharding
from repro.distributed import sharding_rules as jrules
from repro.distributed import tp_matmul as jtp_matmul
from repro.launch import specs as jspecs
from repro.models.transformer import LM as JLM
from repro.serve.engine import prepare_params as jprepare
from repro.train import optimizer as joptim
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.policy import uniform_schedule
from repro_torch.distributed import sharding, sharding_rules, tp_matmul
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import prepare_params
from repro_torch.train import optimizer as optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
# The dry-run shapes' global batches (specs.SHAPES) and one that divides
# no batch axis above 1.
BATCHES = (1, 32, 128, 256, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------- the reference's runs
REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.compression import compressed_psum
from repro.distributed.pipeline import run_pipeline
from repro.distributed.sharding import shard_map
from repro.distributed.tp_matmul import _quantize_rows, tp_mlp_block
from repro.launch.mesh import make_production_mesh
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}


def mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]).reshape((n,)), (name,))


for case, (x, w_up, w_down) in inp["tp"].items():
    for n in (2, 4):
        y = tp_mlp_block(mesh(n, "model"), jnp.asarray(x), jnp.asarray(w_up),
                         jnp.asarray(w_down))
        k = x.shape[-1] // n
        wire = [_quantize_rows(jnp.asarray(x[..., r * k:(r + 1) * k]))
                for r in range(n)]
        out[("tp", case, n)] = {
            "y": np.asarray(y, np.float32),
            "codes": np.concatenate([np.asarray(q) for q, _ in wire], -1),
            "scales": np.concatenate([np.asarray(s, np.float32)
                                      for _, s in wire], -1)}
for n, (g, err) in inp["psum"].items():
    for bits in (8, 2):
        f = jax.jit(shard_map(
            lambda g, e: compressed_psum(g, e, axis_name="dp", bits=bits),
            mesh=mesh(n, "dp"), in_specs=(P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp"))))
        mean, new_err = f(g[:, None], err[:, None])
        out[("psum", n, bits)] = (np.asarray(mean)[:, 0],
                                  np.asarray(new_err)[:, 0])
ws, xs = inp["pipe"]
out["pipe"] = np.asarray(run_pipeline(mesh(4, "stage"),
                                      lambda w, x: jnp.tanh(x @ w),
                                      jnp.asarray(ws), jnp.asarray(xs)))
for shape, axes, specs in inp["layouts"]:
    n = int(np.prod(shape))
    m = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
    order = list(m.devices.flat)
    for spec in specs:
        arr = jax.device_put(jnp.zeros((8, 8, 4)), NamedSharding(m, P(*spec)))
        out[("layout", shape, spec)] = {
            order.index(s.device): tuple(sl.indices(size)[:2]
                                         for sl, size in zip(s.index, (8, 8, 4)))
            for s in arr.addressable_shards}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[("production", multi)] = (tuple(m.devices.shape), tuple(m.axis_names))
pickle.dump(out, open(sys.argv[2], "wb"))
"""

LAYOUTS = (((2, 2), ("data", "model"),
            (("data", "model"), ("model", None), (None, "data"),
             (("data", "model"),), (None, ("model", "data")))),
           ((2, 2, 2), ("pod", "data", "model"),
            ((("pod", "data"), "model"), ("model", ("pod", "data")),
             ("pod", None, "data"))))


def _train_state():
    """A reduced qwen3-8b train state on the CPU: seeded params and AdamW
    moments filled with seeded values (so every block differs)."""
    cfg = reduced_config("qwen3-8b")
    gen = torch.Generator().manual_seed(0)
    params = LM(cfg).init(gen, device="cpu")
    opt = optim.init_state(params, optim.OptConfig())
    for key in ("m", "v"):
        opt[key] = optim.tree_map(
            lambda t: torch.randn(t.shape, generator=gen), opt[key])
    return {"params": params, "opt": opt}


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, the reference's runs and the train state."""
    d = tmp_path_factory.mktemp("dist")
    inputs = {"tp": {c: ranks.tp_inputs(c) for c in ranks.TP_CASES},
              "psum": {n: ranks.psum_inputs(n) for n in (2, 4)},
              "pipe": ranks.pipe_inputs(), "layouts": LAYOUTS}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512 "
                         "--xla_allow_excess_precision=false")
    proc = {}
    thread = threading.Thread(target=lambda: proc.update(r=subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.pkl"),
         str(d / "ref.pkl")], capture_output=True, text=True, env=env,
        timeout=600)))
    thread.start()
    try:
        state = _train_state()
        torch.save(state, d / "state.pt")
        stacked = convert.stack_layers(state)
        jckpt.save(str(d / "ckpt"), 1, jax.tree.map(
            _to_jax, stacked, is_leaf=lambda t: isinstance(t, torch.Tensor)))
        per_rank = mesh_lib.spawn_ranks(4, ranks.run_all, str(d / "state.pt"),
                                        str(d / "ckpt"), device="cpu")
    finally:
        thread.join()
    r = proc["r"]
    assert r.returncode == 0, r.stdout + r.stderr
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"ranks": per_rank, "ref": ref, "state": state,
            "stacked": stacked}


# ------------------------------------------------------- rules (in process)
_ATTRS = ("planes", "packed", "scale", "k", "v", "k_scale", "v_scale",
          "length", "kv_bits", "conv", "state")


def _ref_key(port_path):
    """The reference's keystr of a port path (its periods are stacked: the
    list index goes)."""
    parts = [{"layers": "periods"}.get(p, p) for p in port_path.split(".")
             if not p.isdigit()]
    if parts[-1] not in _ATTRS:
        return "".join(f"[{p!r}]" for p in parts)
    return "".join(f"[{p!r}]" for p in parts[:-1]) + f".{parts[-1]}"


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}


def _ref_specs(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {jax.tree_util.keystr(kp): s.spec for kp, s in flat}


def _check(port_tree, port_specs, ref_tree, ref_specs):
    """Each port leaf's spec is the reference's (a PartitionSpec shorter
    than its leaf replicates the rest), without its period entry for a
    per-layer leaf, whose shape is the stacked one's without the period
    dim; every reference leaf has port leaves.  Returns the count of
    sharded port leaves."""
    ref_leaves = _ref_leaves(ref_tree)
    port_leaves = sharding_rules.leaf_paths(port_tree)
    assert set(port_specs) == set(port_leaves)
    assert {_ref_key(p) for p in port_leaves} == set(ref_leaves)
    sharded = 0
    for path, spec in port_specs.items():
        key = _ref_key(path)
        leaf, want = ref_leaves[key], tuple(ref_specs[key])
        want = want + (None,) * (leaf.ndim - len(want))
        shape = tuple(port_leaves[path].shape)
        if any(p.isdigit() for p in path.split(".")):
            want, ref_shape = want[1:], tuple(leaf.shape[1:])
        else:
            ref_shape = tuple(leaf.shape)
        assert shape == ref_shape, (path, shape, ref_shape)
        assert spec == want, (path, spec, want)
        sharded += any(a is not None for a in spec)
    return sharded


@pytest.fixture(scope="module")
def full_trees():
    """Every arch's full-config params, AdamW state and prepared store in
    both packages, as shapes.  The port's store is prepared for its first
    period only (preparing 48 layers of llama4 on the meta device takes
    17 s): a per-layer leaf's spec depends on its own shape only, and every
    period has the same shapes."""
    out = {}
    jsched = juniform_schedule({"8/8": (8, 8)})
    sched = uniform_schedule({"8/8": (8, 8)}, backend="decomposed")
    for arch in ARCHS:
        cfg, jm = get_config(arch), JLM(jget_config(arch))
        model = LM(cfg)
        params = model.init(torch.Generator(), device="meta")
        jparams = jax.eval_shape(jm.init, jax.random.key(0))
        one = LM(dataclasses.replace(cfg, num_layers=len(model.pattern)))
        first = dict(params, layers=params["layers"][:1])
        out[arch] = {
            "params": (params, jparams),
            "opt": (optim.init_state(params, optim.OptConfig()),
                    jax.eval_shape(lambda p: joptim.init_state(
                        p, joptim.OptConfig()), jparams)),
            "store": (prepare_params(first, sched.prepare_policy(), one,
                                     superplane=True)[0],
                      jax.eval_shape(lambda p: jprepare(
                          p, jsched.prepare_policy(), jm,
                          superplane=True)[0], jparams))}
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tree_shardings_equal_reference(full_trees, arch):
    for shape, axes in MESHES:
        mesh = mesh_lib.Mesh(shape, axes)
        jmesh = jax.sharding.AbstractMesh(shape, axes)
        sharded = 0
        for tree, jtree in full_trees[arch].values():
            sharded += _check(tree, sharding_rules.tree_shardings(mesh, tree),
                              jtree, _ref_specs(jrules.tree_shardings(
                                  jmesh, jtree)))
        assert sharded > 0


def test_grok_expert_fallback_to_tp():
    """8 experts cannot divide a 16-way model axis -> 2D TP fallback (the
    reference's test, on a per-layer leaf and on a stacked one)."""
    mesh = mesh_lib.Mesh((1, 16), ("data", "model"))
    leaf = torch.empty((8, 6144, 32768), device="meta")
    spec = sharding_rules.param_spec(mesh, "layers.0.pos0.moe.gate_proj.w",
                                     leaf)
    assert spec == (None, "data", "model")
    stacked = torch.empty((64, 8, 6144, 32768), device="meta")
    assert sharding_rules.param_spec(
        mesh, "periods.pos0.moe.gate_proj.w", stacked) == (None,) + spec


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b",
                                  "mamba2-1.3b", "musicgen-large"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_cache_specs_equal_reference(arch, kv_bits):
    cfg, jm = get_config(arch), JLM(jget_config(arch))
    model = LM(cfg)
    for b in BATCHES:
        caches = model.init_cache(b, 64, kv_bits=kv_bits, device="meta")
        jcaches = jax.eval_shape(lambda: jm.init_cache(b, 64,
                                                       kv_bits=kv_bits))
        for shape, axes in MESHES:
            mesh = mesh_lib.Mesh(shape, axes)
            jmesh = jax.sharding.AbstractMesh(shape, axes)
            _check(caches, sharding_rules.cache_shardings(mesh, caches),
                   jcaches, _ref_specs(jrules.cache_shardings(jmesh,
                                                              jcaches)))


@pytest.mark.parametrize("arch", ["qwen3-8b", "musicgen-large"])
def test_batch_specs_equal_reference(arch):
    jcfg = jget_config(arch)
    for b in BATCHES:
        for shape, axes in MESHES:
            mesh = mesh_lib.Mesh(shape, axes)
            jmesh = jax.sharding.AbstractMesh(shape, axes)
            for seq in (1, 4096):
                jbatch = jspecs.token_specs(jcfg, b, seq)
                batch = {k: torch.empty(v.shape, device="meta")
                         for k, v in jbatch.items()}
                want = {f"{k}": tuple(v.spec) for k, v in
                        jrules.batch_shardings(jmesh, jbatch).items()}
                assert sharding_rules.batch_shardings(mesh, batch) == want
                for leaf in jbatch.values():
                    assert sharding_rules.batch_spec(mesh, leaf.shape) == \
                        tuple(jrules.batch_spec(jmesh, leaf.shape))


def test_logical_axes_equal_reference():
    assert sharding.LOGICAL_AXES == jsharding.LOGICAL_AXES
    logical = (None, "batch", "fsdp", "model", "expert", "seq", "none",
               "pod", ("pod", "data"), ("x", "model"), ("x",))
    for shape, axes in MESHES + (((4,), ("stage",)),):
        mesh = mesh_lib.Mesh(shape, axes)
        jmesh = jax.sharding.AbstractMesh(shape, axes)
        for a in logical:
            assert sharding.resolve_axis(mesh, a) == \
                jsharding.resolve_axis(jmesh, a)
        assert sharding.make_spec(mesh, *logical) == \
            tuple(jsharding.make_spec(jmesh, *logical))
        for dim in (1, 2, 16, 48, 256, 512):
            for a in logical:
                assert sharding.mesh_divides(mesh, dim, a) == \
                    jsharding.mesh_divides(jmesh, dim, a)
    assert not sharding.mesh_divides(None, 4, "model")


def test_block_bytes_reckoning():
    """A rank's bytes are each leaf's over its block count (2 x 2 rules on
    a qwen3-8b projection and a norm, bf16)."""
    mesh = mesh_lib.Mesh((2, 2), ("data", "model"))
    tree = {"layers": [{"pos0": {"attn": {"q_proj": {"w": torch.empty(
        (4096, 4096), dtype=torch.bfloat16, device="meta")}},
        "mixer_norm": {"g": torch.empty((4096,), dtype=torch.bfloat16,
                                        device="meta")}}}]}
    specs = sharding_rules.tree_shardings(mesh, tree)
    assert specs["layers.0.pos0.attn.q_proj.w"] == ("data", "model")
    assert sharding_rules.block_bytes(tree, specs, mesh) == \
        4096 * 4096 * 2 // 4 + 4096 * 2


def test_dotted_path():
    assert sharding_rules.dotted_path(
        "['opt']['m']['periods']['pos0']['attn']['q_proj']['w']") == \
        "opt.m.periods.pos0.attn.q_proj.w"
    assert sharding_rules.dotted_path("['lm_head']['w'].planes") == \
        "lm_head.w.planes"
    assert sharding_rules.dotted_path("[0]['pos0'].k") == "0.pos0.k"


def test_make_mesh_needs_a_group():
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        mesh_lib.make_mesh((2,), ("data", "model"), device="cpu")


def test_napkin_math_equals_reference():
    for d, f, n in ((4096, 12288, 2), (4096, 12288, 4), (4096, 12288, 16),
                    (64, 128, 4)):
        assert tp_matmul.collective_bytes_per_token(d, f, n) == \
            jtp_matmul.collective_bytes_per_token(d, f, n)


# ------------------------------------------------------------ across ranks
def test_production_meshes_equal_reference(runs):
    for multi in (False, True):
        m = mesh_lib.make_production_mesh(multi_pod=multi)
        assert (m.shape, m.axis_names) == runs["ref"][("production", multi)]
        assert not m.bound and m.n == (512 if multi else 256)


def test_mesh_coordinates_and_errors(runs):
    for r, out in enumerate(runs["ranks"]):
        assert out[("coords", (4,))] == (r,)
        assert out[("coords", (2, 2))] == (r // 2, r % 2)
        assert out["mesh_error"] == ("a (2, 4) mesh needs 8 ranks but the "
                                     "default group has 4")


@pytest.mark.parametrize("spec_set", range(2))
def test_block_layout_equals_jax_device_layout(runs, spec_set):
    """Rank r's block under a spec is the shard JAX puts on the mesh's
    r-th device (row-major), tuple axes (major first) included."""
    shape, axes, specs = LAYOUTS[spec_set]
    mesh = mesh_lib.Mesh(shape, axes)
    for spec in specs:
        full = spec + (None,) * (3 - len(spec))
        want = runs["ref"][("layout", shape, spec)]
        for r in range(mesh.n):
            got = sharding_rules._block_slices((8, 8, 4), full, mesh,
                                               mesh.coords_of(r))
            assert tuple(s.indices(size)[:2] for s, size in
                         zip(got, (8, 8, 4))) == want[r], (spec, r)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(ranks.TP_CASES))
def test_tp_mlp_block(runs, n, case):
    """The wire's codes and scales equal the reference's quantizer bit for
    bit; y equals the reference's within one bf16 ulp and is the same on
    every rank; y is within the reference test's 5 % of the f32 MLP; the bytes
    gathered and reduced per token are ``collective_bytes_per_token``'s."""
    ref = runs["ref"][("tp", case, n)]
    x, w_up, w_down = ranks.tp_inputs(case)
    h = np.asarray(jax.nn.gelu(jnp.asarray(x @ w_up, jnp.float32)))
    want = h @ w_down
    outs = [r[("tp", n)][case] for r in runs["ranks"]]
    d, f = w_up.shape
    est = tp_matmul.collective_bytes_per_token(d, f, n)
    rows = int(np.prod(x.shape[:-1]))
    for o in outs:
        assert np.array_equal(o["codes"], ref["codes"])
        assert np.array_equal(o["scales"], ref["scales"])
        assert np.array_equal(o["y"], outs[0]["y"])
        assert o["codes"].dtype == np.int8
        assert (o["codes"].nbytes + o["scales"].size * 2) / rows == \
            est["gather_int8"]
        assert np.prod(o["partial"]) * 2 / rows == est["reduce_scatter_bf16"]
    y = outs[0]["y"]
    # XLA's reduce-scatter adds the partial sums in another order: one bf16
    # ulp of the largest output (equal at n = 2, 1 ulp apart at n = 4).
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref["y"]).max())) - 7)
    assert np.abs(y - ref["y"]).max() <= ulp
    assert np.abs(y - want).max() / np.abs(want).max() < 0.05


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bits", [8, 2])
def test_compressed_psum(runs, n, bits):
    """The mean equals the jitted reference's bit for bit; the residual
    within 1e-6 (the jitted reference may contract it into one FMA, as
    its own test allows)."""
    mean, err = runs["ref"][("psum", n, bits)]
    for r, out in enumerate(runs["ranks"][:4]):
        i = r % n          # the "dp" axis is the last
        got_mean, got_err = out[("psum", n)][bits]
        assert np.array_equal(got_mean, mean[i])
        np.testing.assert_allclose(got_err, err[i], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_error_feedback_reduces_bias(runs, n):
    g = ranks.ef_inputs(n)
    want = g.mean(0) * ranks.EF_ROUNDS
    for out in runs["ranks"]:
        acc = out[("psum", n)]["ef"]
        assert np.abs(acc - want).max() / np.abs(want).max() < 0.01


def test_pipeline_equals_reference_and_sequential(runs):
    for out in runs["ranks"]:
        got = out["pipe"]["got"]
        assert np.array_equal(got, out["pipe"]["sequential"])
        np.testing.assert_allclose(got, runs["ref"]["pipe"], atol=1e-6,
                                   rtol=0)


def _whole_leaves(tree):
    return {p: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for p, t in sharding_rules.leaf_paths(tree).items()}


def test_gather_tree_of_blocks_is_the_whole(runs):
    """The four ranks' blocks of the train state under the (2, 2) rules
    put back by ``gather_tree`` equal the whole, and each is the slice of
    the whole its coordinates name (np.split along each sharded dim)."""
    mesh = mesh_lib.Mesh((2, 2), ("data", "model"))
    state = runs["state"]
    specs = sharding_rules.tree_shardings(mesh, state)
    blocks = [{p: torch.from_numpy(a) for p, a in r["blocks"].items()}
              for r in runs["ranks"]]
    got = sharding_rules.gather_tree(blocks, specs, mesh)
    whole = _whole_leaves(state)
    assert set(got) == set(whole)
    for path, t in _whole_leaves(got).items():
        assert np.array_equal(t, whole[path]), path
    assert any(a is not None for s in specs.values() for a in s)
    for r, out in enumerate(runs["ranks"]):
        _check_slices(out["blocks"], whole, specs, mesh, r)


def _check_slices(blocks, whole, specs, mesh, rank):
    coords = dict(zip(mesh.axis_names, mesh.coords_of(rank)))
    for path, spec in specs.items():
        want = whole[path]
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            names = axis if isinstance(axis, tuple) else (axis,)
            index, n = 0, 1
            for a in names:
                index = index * mesh.axis_size(a) + coords[a]
                n *= mesh.axis_size(a)
            want = np.split(want, n, axis=dim)[index]
        assert np.array_equal(blocks[path], want), (path, rank)


@pytest.mark.parametrize("label", list(ranks.RESTORE_MESHES))
def test_checkpoint_restores_onto_a_mesh(runs, label):
    """A train state saved by the reference's ``checkpoint.save`` (stacked
    periods) restores on each rank to its blocks under the training rules:
    the (2, 2) FSDP x TP mesh and 4-way FSDP over ``data``."""
    shape, axes = ranks.RESTORE_MESHES[label]
    mesh = mesh_lib.Mesh(shape, axes)
    stacked = runs["stacked"]
    specs = sharding_rules.tree_shardings(mesh, stacked)
    whole = _whole_leaves(stacked)
    assert any(a is not None for s in specs.values() for a in s)
    for r, out in enumerate(runs["ranks"]):
        _check_slices(out[("restore", label)], whole, specs, mesh, r)
