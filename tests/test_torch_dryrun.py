"""repro_torch's dry-run and roofline tools held against the JAX package:
``launch/specs`` (shapes, skip rule, stand-ins, MODEL_FLOPS), the cost
walker ``launch/hlo_cost`` (over dispatched torch ops on meta tensors),
``launch/dryrun`` and ``dryrun_all`` (the reduced cells, the command
lines) and ``launch/roofline`` (the H100's constants).

ONE JAX subprocess with 4 host devices runs the reference's
``dryrun.run_cell(reduced=True)`` on three cells, with ``jax.make_mesh``
wrapped to Auto axes in that process only (jax 0.9's default Explicit axes
refuse the reference's ``with_sharding_constraint``), and the reference's
``hlo_cost.analyze`` of four whole steps jitted on one device.  It runs
beside the port's cells.  The walker's toy loops are held against the
reference's jitted scans in process.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.policy import uniform_policy
from repro_torch.distributed import sharding_rules
from repro_torch.launch import dryrun, dryrun_all, hlo_cost, roofline, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import prepare_params
from repro_torch.train import optimizer as optim
from repro_torch.train.step import make_serve_steps, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# (arch, shape, kv_bits): the reduced cells held against the reference's.
CELLS = (("qwen3-8b", "train_4k", None), ("mamba2-1.3b", "long_500k", 8),
         ("qwen3-8b", "decode_32k", None))
META_KEYS = ("arch", "family", "shape", "kind", "seq_len", "global_batch",
             "mesh", "axes", "n_devices", "backend", "w_bits", "a_bits",
             "kv_bits", "packed", "accum", "param_count",
             "active_param_count", "model_flops")
# A prefill whose flash-attention K/V loop makes three trips (block_k 1024).
PREFILL_SEQ = 3072
# XLA's output buffer of a step holds the output tuple's index table: one
# 8-byte pointer per output leaf.
TUPLE_ENTRY_BYTES = 8


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
import json, os, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def make_mesh(shape, names, *args, **kwargs):
    kwargs.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, names, *args, **kwargs)


jax.make_mesh = make_mesh
from repro.configs import reduced_config
from repro.core.policy import uniform_policy
from repro.launch import dryrun, hlo_cost
from repro.models.layers import Runtime
from repro.models.transformer import LM
from repro.serve.engine import prepare_params
from repro.train import optimizer as optim
from repro.train.step import make_serve_steps, make_train_step

cells = {}
for arch, shape, kv in json.loads(sys.argv[1]):
    res = dryrun.run_cell(arch, shape, reduced=True, kv_bits=kv)
    res.pop("xla_cost_raw")
    cells[f"{arch}/{shape}"] = res


def flops(fn, *shapes):
    return hlo_cost.analyze(jax.jit(fn).lower(*shapes).compile().as_text()
                            )["flops"]


sds = jax.ShapeDtypeStruct
steps = {}
cfg = reduced_config("qwen3-8b")
model = LM(cfg)
params = jax.eval_shape(model.init, jax.random.key(0))
tok = sds((8, 128), jnp.int32)
dense = Runtime(policy=uniform_policy(8, 8, backend="dense"))
steps["forward"] = flops(lambda p, t: model.forward(p, dense, tokens=t)[0],
                         params, tok)
rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant"))
ocfg = optim.OptConfig(moment_dtype="bfloat16")
state = {"params": params,
         "opt": jax.eval_shape(lambda p: optim.init_state(p, ocfg), params)}
steps["train"] = flops(make_train_step(model, rt, ocfg), state,
                       {"tokens": tok, "labels": tok})
for arch, batch, kv in (("qwen3-8b", 8, None), ("mamba2-1.3b", 1, 8)):
    m = LM(reduced_config(arch))
    rt = Runtime(policy=uniform_policy(4, 8, backend="decomposed"),
                 mode="serve")
    store = jax.eval_shape(lambda p: prepare_params(p, rt.policy, m)[0],
                           jax.eval_shape(m.init, jax.random.key(0)))
    caches = jax.eval_shape(lambda: m.init_cache(batch, 128, kv_bits=kv))
    prefill, decode = make_serve_steps(m, rt)
    steps[f"decode/{arch}"] = flops(
        lambda p, c, t: decode(p, c, tokens=t), store, caches,
        sds((batch, 1), jnp.int32))
# A prefill over PREFILL_SEQ: flash attention's K/V loop makes several
# trips (block_k 1024).
m = LM(reduced_config("qwen3-8b"))
store = jax.eval_shape(lambda p: prepare_params(p, rt.policy, m)[0],
                       jax.eval_shape(m.init, jax.random.key(0)))
caches = jax.eval_shape(lambda: m.init_cache(1, int(sys.argv[2])))
prefill = make_serve_steps(m, rt)[0]
steps["prefill"] = flops(lambda p, c, t: prefill(p, c, tokens=t), store,
                         caches, sds((1, int(sys.argv[2])), jnp.int32))
print("RESULT " + json.dumps({"cells": cells, "steps": steps}))
"""


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Starts the reference's subprocess with the module's first test; the
    tests that read it wait for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS),
         str(PREFILL_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    done = {}

    def result():
        if not done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-2000:] + err[-4000:]
            line = next(l for l in out.splitlines() if l.startswith("RESULT "))
            done.update(json.loads(line[len("RESULT "):]))
        return done
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ------------------------------------------------------------------ specs
def _like(tree, jtree):
    """The port's stand-ins have the reference's keys, shapes and dtypes."""
    assert set(tree) == set(jtree)
    for k, t in tree.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jtree[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(jtree[k].dtype), k


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}
    assert dryrun_all.SHAPE_ORDER == SHAPE_NAMES
    assert list(dryrun_all.cells()) == [(a, s) for a in ARCHS
                                        for s in SHAPE_NAMES]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_specs_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sp, jsp = specs.SHAPES[shape], jspecs.SHAPES[shape]
    assert specs.cell_applicable(cfg, sp) == jspecs.cell_applicable(jcfg, jsp)
    assert specs.model_flops(cfg, sp) == jspecs.model_flops(jcfg, jsp)
    _like(specs.batch_specs(cfg, sp), jspecs.batch_specs(jcfg, jsp))
    for seq in (sp.seq_len, 1):
        _like(specs.token_specs(cfg, sp.global_batch, seq),
              jspecs.token_specs(jcfg, sp.global_batch, seq))


# ------------------------------------------------------------ cost walker
def _jitted_flops(f, *shapes):
    return jhlo_cost.analyze(jax.jit(f).lower(*shapes).compile().as_text()
                             )["flops"]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_flops_equal_reference_scan():
    def body(x, w):
        return torch.tanh(x @ w)

    def f(x, ws):
        for i in range(ws.shape[0]):
            x = body(x, ws[i])
        return x

    def f_scan(x, ws):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]

    got = hlo_cost.analyze(f, _meta(64, 128), _meta(8, 128, 128))
    assert got["flops"] == 2 * 64 * 128 * 128 * 8 == _jitted_flops(
        f_scan, jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((8, 128, 128), jnp.float32))


def test_nested_loop_flops_equal_reference_scan():
    def f(x, ws):
        for i in range(ws.shape[0]):
            for _ in range(3):
                x = torch.tanh(x @ ws[i])
        return x

    def f_scan(x, ws):
        def outer(x, w):
            def inner(y, _):
                return jnp.tanh(y @ w), None
            return jax.lax.scan(inner, x, None, length=3)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    got = hlo_cost.analyze(f, _meta(32, 64), _meta(4, 64, 64))
    assert got["flops"] == 2 * 32 * 64 * 64 * 4 * 3 == _jitted_flops(
        f_scan, jax.ShapeDtypeStruct((32, 64), jnp.float32),
        jax.ShapeDtypeStruct((4, 64, 64), jnp.float32))


def test_plain_matmul_flops_and_bytes():
    got = hlo_cost.analyze(lambda a, b: a @ b,
                           _meta(128, 256, dtype=torch.bfloat16),
                           _meta(256, 512, dtype=torch.bfloat16))
    assert got["flops"] == 2 * 128 * 256 * 512
    assert got["bytes"] == (128 * 256 + 256 * 512 + 128 * 512) * 2


def test_bytes_conventions():
    """Views are free, a broadcast operand is read once, an in-place
    update moves its region twice; every storage made is live until
    freed."""
    x = _meta(64, 128)
    _, mode = hlo_cost.count(lambda x: x.t()[:8].expand(4, 8, 64).sum(), x)
    assert mode.cost.bytes == 8 * 64 * 4 + 4
    dst = _meta(1024, 16)
    _, mode = hlo_cost.count(lambda d, s: d[8:12].copy_(s), dst, _meta(4, 16))
    assert mode.cost.bytes == 2 * 4 * 16 * 4

    def chain(x):
        y = torch.exp(x)
        z = torch.exp(y)
        del y
        return torch.exp(z)
    _, mode = hlo_cost.count(chain, _meta(1000))
    assert mode.peak_bytes == 2 * 4000 and mode.n_ops == 3


def test_collective_convention_equals_reference():
    hlo = """
HloModule test

ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  %ag = f32[64,128]{1,0} all-gather(%x), replica_groups=[16,4]<=[64], dimensions={0}
  %ar = f32[64,128]{1,0} all-reduce(%ag), replica_groups=[8,8]<=[64], to_apply=%add
  %rs = f32[64,128]{1,0} reduce-scatter(%ar), replica_groups=[16,4]<=[64], dimensions={0}
  ROOT %cp = f32[64,128]{1,0} collective-permute(%rs), source_target_pairs={{0,1}}
}
"""
    n = 64 * 128 * 4
    cost = hlo_cost.Cost()
    cost.add_collective("all-gather", n, 4, f32=True)
    cost.add_collective("all-reduce", n, 8, f32=True)
    cost.add_collective("reduce-scatter", n, 4, f32=True)
    cost.add_collective("collective-permute", n, 2, f32=True)
    assert cost.as_dict()["collectives"] == \
        jhlo_cost.analyze(hlo)["collectives"]
    c = cost.as_dict()["collectives"]["bytes_per_op"]
    assert c["all-gather"] == n / 4 and c["reduce-scatter"] == n * 4


def test_collectives_reckoned_on_two_leaves():
    """Hand numbers: a bf16 projection that FSDP ("data") and TP ("model")
    both cut and an f32 norm that neither does, on 2 x 2 and on 2 x 2 x 2
    (pod, data, model) with a batch of 8.  A column-parallel projection
    alone closes no TP region: no activation collective."""
    tree = {"layers": [{"pos0": {
        "attn": {"q_proj": {"w": _meta(64, 128, dtype=torch.bfloat16)}},
        "mixer_norm": {"g": _meta(64)}}}]}
    shard = 64 * 128 * 2 // 2            # the TP shard a device computes on
    mesh = Mesh((2, 2), ("data", "model"))
    sh = sharding_rules.tree_shardings(mesh, tree)
    assert sh["layers.0.pos0.attn.q_proj.w"] == ("data", "model")
    assert sh["layers.0.pos0.mixer_norm.g"] == (None,)
    kw = dict(tokens=8 * 16, row_bytes=64 * 2, lookup=True)
    train = dryrun.reckon_collectives(tree, sh, mesh, train=True, batch=8,
                                      **kw).as_dict()["collectives"]
    assert train["bytes_per_op"] == {
        "all-gather": shard / 2, "reduce-scatter": shard, "all-reduce": 64 * 4,
        "all-to-all": 0, "collective-permute": 0}
    assert train["counts"] == {"all-gather": 1, "reduce-scatter": 1,
                               "all-reduce": 1, "all-to-all": 0,
                               "collective-permute": 0}
    assert train["f32_bytes"] == 64 * 4
    assert train["total_bytes"] == shard / 2 + shard + 64 * 4
    # An odd batch is not split: the norm's gradient needs no sum.
    odd = dryrun.reckon_collectives(tree, sh, mesh, train=True, batch=3,
                                    **kw)
    assert odd.coll_bytes["all-reduce"] == 0
    serve = dryrun.reckon_collectives(tree, sh, mesh, train=False, batch=8,
                                      **kw)
    assert serve.collective_bytes == shard / 2 and serve.coll_bytes_f32 == 0
    # Two pods: the block's gradient is also summed across the pod axis.
    pods = Mesh((2, 2, 2), ("pod", "data", "model"))
    sh = sharding_rules.tree_shardings(pods, tree)
    assert sh["layers.0.pos0.attn.q_proj.w"] == ("data", "model")
    got = dryrun.reckon_collectives(tree, sh, pods, train=True, batch=8,
                                    **kw)
    assert got.coll_bytes == {
        "all-gather": shard / 2, "reduce-scatter": shard,
        "all-reduce": shard / 2 + 64 * 4, "all-to-all": 0,
        "collective-permute": 0}
    assert got.coll_counts["all-reduce"] == 2


def test_activation_collectives_reckoned_by_hand():
    """Hand numbers of the TP / EP activation all-reduces on 2 x 2: an
    attention block (q column-, o row-parallel), an MoE block whose expert
    bank is cut on E (EP) beside a shared expert (one region), the
    embedding and the head; 8 x 4 tokens over the data axis, d 16 bf16."""
    bf16 = dict(dtype=torch.bfloat16)
    tree = {"embed": {"emb": _meta(64, 16, **bf16)},
            "layers": [{"pos0": {
                "attn": {"q_proj": {"w": _meta(16, 32, **bf16)},
                         "o_proj": {"w": _meta(32, 16, **bf16)}},
                "moe": {"down_proj": {"w": _meta(4, 32, 16, **bf16)},
                        "shared": {"down_proj": {"w": _meta(32, 16,
                                                           **bf16)}}}}}],
            "lm_head": {"w": _meta(16, 64, **bf16)}}
    mesh = Mesh((2, 2), ("data", "model"))
    sh = sharding_rules.tree_shardings(mesh, tree)
    assert sh["layers.0.pos0.moe.down_proj.w"] == ("model", "data", None)
    assert sh["embed.emb"] == ("model", "data")
    assert sh["lm_head.w"] == ("data", "model")
    weights = dryrun.reckon_collectives(tree, sh, mesh, train=True, batch=8,
                                        tokens=0, row_bytes=32, lookup=True)
    assert weights.coll_bytes["all-reduce"] == 0
    rows = 8 * 4 // 2 * 16 * 2              # a device's rows, bytes

    def acts(**kw):
        c = dryrun.reckon_collectives(tree, sh, mesh, batch=8, tokens=8 * 4,
                                      row_bytes=16 * 2, **kw)
        return c.coll_bytes["all-reduce"], c.coll_counts["all-reduce"]
    # attn and moe forward + backward, the embedding's forward, the head's
    # backward.
    assert acts(train=True, lookup=True) == (6 * rows, 6)
    assert acts(train=True, lookup=False) == (5 * rows, 5)
    # Serving: the forward all-reduces only.
    assert acts(train=False, lookup=True) == (3 * rows, 3)
    # One device per "model" group: nothing to reduce.
    one = Mesh((4, 1), ("data", "model"))
    c = dryrun.reckon_collectives(
        tree, sharding_rules.tree_shardings(one, tree), one, train=True,
        batch=8, tokens=32, row_bytes=32, lookup=True)
    assert c.coll_counts["all-reduce"] == 0


# ------------------------------------------- whole steps (one device)
def _qwen():
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    return cfg, model, model.init(torch.Generator(), device="meta")


def _decode_flops(arch: str, batch: int, kv_bits) -> float:
    model = LM(reduced_config(arch))
    rt = Runtime(policy=uniform_policy(4, 8, backend="decomposed"))
    store = prepare_params(model.init(torch.Generator(), device="meta"),
                           rt.policy, model)[0]
    caches = model.init_cache(batch, 128, kv_bits=kv_bits, device="meta")
    decode = make_serve_steps(model, rt)[1]
    return hlo_cost.analyze(decode, store, caches,
                            tokens=_meta(batch, 1, dtype=torch.int32))["flops"]


def test_steps_equal_reference_on_one_device(reference):
    cfg, model, params = _qwen()
    tok = _meta(8, 128, dtype=torch.int32)
    dense = Runtime(policy=uniform_policy(8, 8, backend="dense"))
    forward = hlo_cost.analyze(lambda p, t: model.forward(p, dense,
                                                          tokens=t)[0],
                               params, tok)["flops"]
    ocfg = optim.OptConfig(moment_dtype="bfloat16")
    rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant"))
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    train = hlo_cost.analyze(make_train_step(model, rt, ocfg), state,
                             {"tokens": tok, "labels": tok})["flops"]
    decode = _decode_flops("qwen3-8b", 8, None)
    ssm_decode = _decode_flops("mamba2-1.3b", 1, 8)
    rt = Runtime(policy=uniform_policy(4, 8, backend="decomposed"))
    store = prepare_params(params, rt.policy, model)[0]
    prefill = hlo_cost.analyze(
        make_serve_steps(model, rt)[0], store,
        model.init_cache(1, PREFILL_SEQ, device="meta"),
        tokens=_meta(1, PREFILL_SEQ, dtype=torch.int32))["flops"]
    ref = reference()["steps"]
    assert prefill == ref["prefill"]
    assert forward == ref["forward"] == 276_824_064
    assert decode == ref["decode/qwen3-8b"] == 3_801_088
    assert ssm_decode == ref["decode/mamba2-1.3b"]
    # Eager autograd: forward + backward = 3 x the forward.  The reference
    # wraps each layer in jax.checkpoint, so its backward runs the layers'
    # forward once more: the forward without the head's matmul.
    assert train == 3 * forward == 830_472_192
    head = 2 * 8 * 128 * cfg.d_model * cfg.padded_vocab
    assert train + (forward - head) == ref["train"] == 1_040_187_392


# -------------------------------------------------- the reduced cells
def _stacked_leaves(tree) -> int:
    """The reference's leaf count of ``tree``: its per-period lists
    stacked into one leaf each."""
    return len({tuple(p for p in path.split(".") if not p.isdigit())
                for path in sharding_rules.leaf_paths(tree)})


@pytest.mark.parametrize("arch,shape,kv_bits", CELLS)
def test_reduced_cell_equals_reference(reference, arch, shape, kv_bits):
    res = dryrun.run_cell(arch, shape, reduced=True, kv_bits=kv_bits)
    cell, _ = dryrun.build_cell(arch, shape, multi_pod=False, backend=None,
                                w_bits=4, a_bits=8, kv_bits=kv_bits,
                                reduced=True)
    ref = reference()["cells"][f"{arch}/{shape}"]
    assert not res["skipped"] and not ref["skipped"]
    assert {k: res[k] for k in META_KEYS} == {k: ref[k] for k in META_KEYS}
    mem, rmem = res["memory"], ref["memory"]
    assert mem["argument_size_in_bytes"] == rmem["argument_size_in_bytes"]
    assert mem["alias_size_in_bytes"] == rmem["alias_size_in_bytes"]
    # The output: what the port returns, plus XLA's tuple table.
    leaves = _stacked_leaves(cell.donated) + (5 if res["kind"] == "train"
                                              else 1)
    assert mem["output_size_in_bytes"] + TUPLE_ENTRY_BYTES * leaves == \
        rmem["output_size_in_bytes"]
    if arch == "qwen3-8b" and shape == "train_4k":
        assert mem["argument_size_in_bytes"] == 209_156
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    assert mem["temp_size_in_bytes"] > 0 and res["hlo_lines"] > 0
    assert res["collectives"]["total_bytes"] > 0
    # The least bytes: every argument once, every output once, a decode
    # step's KV cache only at its one position (an SSM state is rewritten
    # whole).
    args, outs = mem["argument_size_in_bytes"], mem["output_size_in_bytes"]
    if res["kind"] == "train" or res["family"] == "ssm":
        assert res["min_bytes_accessed"] == args + outs
    else:
        assert args < res["min_bytes_accessed"] < args + outs
    assert set(res) == set(ref) - {"collectives_unscaled"} \
        | {"min_bytes_accessed"}


def test_cell_on_a_device_counts_as_on_meta():
    """The cell built on a real device (the CPU here, the card in the smoke
    script) runs the same step: FlopCounterMode over it counts what the
    meta reckoning counts."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = Mesh((1, 1), ("data", "model"))
    kw = dict(multi_pod=False, backend=None, w_bits=4, a_bits=8,
              kv_bits=None, reduced=True, mesh=mesh)
    for shape in ("decode_32k", specs.ShapeSpec("train_small", "train", 16,
                                                 2)):
        cell, _ = dryrun.build_cell("qwen3-8b", shape, device="cpu", **kw)
        assert all(t.device.type == "cpu" for t in cell.kwargs.values())
        with FlopCounterMode(display=False) as counter:
            cell.step(*cell.args, **cell.kwargs)
        res = dryrun.run_cell("qwen3-8b", shape, reduced=True, mesh=mesh)
        assert counter.get_total_flops() == res["flops"] > 0


def test_cuda_backend_refused():
    with pytest.raises(ValueError, match="decomposed"):
        dryrun.build_cell("qwen3-8b", "decode_32k", multi_pod=False,
                          backend="cuda", w_bits=4, a_bits=8, kv_bits=None,
                          reduced=True)


def test_run_cell_takes_objects():
    """A config, a ShapeSpec and a mesh given as objects (what the card's
    smoke script reckons its own shapes with)."""
    cfg = reduced_config("qwen3-8b")
    shape = specs.ShapeSpec("train_small", "train", 32, 2)
    res = dryrun.run_cell(cfg, shape, mesh=Mesh((1, 1), ("data", "model")))
    assert res["mesh"] == "1x1" and res["n_devices"] == 1
    assert res["seq_len"] == 32 and res["global_batch"] == 2
    assert res["collectives"]["total_bytes"] == 0
    skip = dryrun.run_cell(cfg, specs.SHAPES["long_500k"],
                           mesh=Mesh((1, 1), ("data", "model")))
    assert skip["skipped"] and skip["mesh"] == "1x1"


# ----------------------------------------------------- the command lines
def _cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def test_command_lines(tmp_path):
    """dryrun writes the reference's file name; --backend cuda is refused;
    dryrun_all skips cached cells and runs the one that is not (qwen3-8b's
    long_500k, a SKIP)."""
    out = tmp_path / "dryrun"
    cached = tmp_path / "all"
    cached.mkdir()
    for shape in SHAPE_NAMES[:3]:
        (cached / f"qwen3-8b__{shape}__16x16.json").write_text("{}")
    procs = {
        "one": _cli("repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                    "--shape", "train_4k", "--reduced", "--dump-hlo",
                    "--out", str(out)),
        "cuda": _cli("repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                     "--shape", "decode_32k", "--reduced", "--backend",
                     "cuda", "--out", str(out)),
        "all": _cli("repro_torch.launch.dryrun_all", "--only-arch",
                    "qwen3-8b", "--out", str(cached))}
    res = {k: p.communicate(timeout=300) + (p.returncode,)
           for k, p in procs.items()}
    stdout, stderr, rc = res["one"]
    assert rc == 0, stdout + stderr
    cell = json.loads((out / "qwen3-8b__train_4k__2x2.json").read_text())
    assert not cell["skipped"] and cell["mesh"] == "2x2"
    assert cell["memory"]["argument_size_in_bytes"] == 209_156
    assert (out / "qwen3-8b__train_4k__2x2.ops.tsv.gz").exists()
    assert "[OK] qwen3-8b__train_4k__2x2" in stdout
    stdout, stderr, rc = res["cuda"]
    assert rc != 0 and "decomposed" in stderr
    stdout, stderr, rc = res["all"]
    assert rc == 0, stdout + stderr
    for shape in SHAPE_NAMES[:3]:
        assert f"[cached] qwen3-8b__{shape}__16x16" in stdout
    assert "[ok" in stdout and "0 failures" in stdout
    skipped = json.loads((cached / "qwen3-8b__long_500k__16x16.json"
                          ).read_text())
    assert skipped["skipped"] and "sub-quadratic" in skipped["reason"]


# -------------------------------------------------------------- roofline
def _cell(flops=1e12, byts=1e12, coll=1e10, f32_coll=0.0, chips=256,
          model_flops=1e15, min_byts=1e11):
    return {
        "skipped": False, "arch": "x", "shape": "train_4k", "mesh": "16x16",
        "backend": "fake_quant", "n_devices": chips,
        "flops": flops, "bytes_accessed": byts, "min_bytes_accessed": min_byts,
        "collectives": {"total_bytes": coll, "f32_bytes": f32_coll},
        "model_flops": model_flops,
    }


def test_roofline_terms_and_dominance():
    t = roofline.roofline_terms(_cell(flops=989e12, byts=3.35e12,
                                      coll=50e9, min_byts=3.35e12))
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["min_memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    t2 = roofline.roofline_terms(_cell(min_byts=33.5e12))
    assert t2["dominant"] == "memory"
    assert t2["step_time_bound_s"] == pytest.approx(10.0)
    # The eager op trace's bytes are reported, not bounded by.
    t3 = roofline.roofline_terms(_cell(byts=33.5e12))
    assert t3["memory_s"] == pytest.approx(10.0)
    assert t3["dominant"] == "collective"
    assert t3["step_time_bound_s"] == pytest.approx(0.2)


def test_roofline_drops_the_tpu_adjustment():
    """XLA:CPU's f32 promotion is not the port's: no adjusted term, and
    f32 collectives cost what they move."""
    t = roofline.roofline_terms(_cell(coll=100e9, f32_coll=100e9))
    assert "collective_tpu_adj_s" not in t
    assert t["collective_s"] == pytest.approx(100e9 / roofline.LINK_BW)


def test_roofline_useful_ratio_and_fraction():
    c = _cell(flops=2e12, chips=100, model_flops=1e14)
    t = roofline.roofline_terms(c)
    assert t["useful_ratio"] == pytest.approx(1e14 / 2e14)
    assert 0 < t["roofline_fraction"] <= 1.0


def test_roofline_int8_peak_scales_compute_term():
    c = _cell()
    a = roofline.roofline_terms(c, int8_peak=False)
    b = roofline.roofline_terms(c, int8_peak=True)
    assert b["compute_s"] == pytest.approx(
        a["compute_s"] * roofline.PEAK_FLOPS_BF16 / roofline.PEAK_OPS_INT8)


def test_roofline_skipped_cells_render():
    cells = [{"skipped": True, "arch": "a", "shape": "long_500k",
              "mesh": "16x16", "reason": "pure full-attention"},
             _cell(min_byts=33.5e12)]
    table = roofline.format_table(cells)
    assert "SKIP" in table and "**memory**" in table
    assert roofline.HARDWARE in table


@pytest.mark.parametrize("int8", [False, True])
def test_roofline_scales_to_reference_by_constants(int8):
    """On the same cell dicts, each term times the H100's constant equals
    the reference's term times the TPU's (both are the same count)."""
    h100 = (roofline.PEAK_OPS_INT8 if int8 else roofline.PEAK_FLOPS_BF16,
            roofline.HBM_BW, roofline.LINK_BW)
    tpu = (jroofline.PEAK_OPS_INT8 if int8 else jroofline.PEAK_FLOPS_BF16,
           jroofline.HBM_BW, jroofline.LINK_BW)
    for c in (_cell(), _cell(flops=3e14, byts=7e10, coll=2e9, chips=512)):
        t = roofline.roofline_terms(c, int8_peak=int8)
        r = jroofline.roofline_terms(c, int8_peak=int8)
        for key, mine, theirs in zip(("compute_s", "memory_s",
                                      "collective_s"), h100, tpu):
            assert t[key] * mine == pytest.approx(r[key] * theirs,
                                                  rel=1e-12)
        assert t["useful_ratio"] == r["useful_ratio"]


def test_roofline_holds_no_tpu_constant():
    """The H100's data-sheet peaks; the link is one 400 Gb/s NIC a card,
    whose 50 GB/s happens to be the TPU's ICI link figure too."""
    for name in ("PEAK_FLOPS_BF16", "PEAK_OPS_INT8", "HBM_BW"):
        assert getattr(roofline, name) != getattr(jroofline, name)
    assert (roofline.PEAK_FLOPS_BF16, roofline.PEAK_OPS_INT8,
            roofline.HBM_BW, roofline.LINK_BW) == (989e12, 1979e12,
                                                   3.35e12, 50e9)
