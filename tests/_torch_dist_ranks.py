"""The rank side of tests/test_torch_distributed.py: what each of the
module's four gloo CPU ranks runs (``launch.mesh.spawn_ranks``).  It
imports torch and the port only, so the spawned ranks start without jax;
the module holds the results against the JAX package.

Every rank runs :func:`run_all`, making the same meshes in the same order
(``make_mesh`` is collective).  2-rank runs use one line of a (2, 2)
mesh.  Inputs come from numpy seeds (:func:`tp_inputs`, :func:`psum_inputs`,
:func:`pipe_inputs`), which the module's JAX subprocess makes alike.
Results are numpy (bf16 as f32, exact).
"""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.distributed import compression, pipeline, tp_matmul
from repro_torch.distributed import sharding_rules as rules
from repro_torch.launch.mesh import make_mesh

TP_CASES = {"2d": ((6, 64), 64, 128), "3d": ((2, 5, 128), 128, 256)}
PSUM_SHAPE = (16, 32)
EF_SHAPE = (8, 8)
EF_ROUNDS = 20
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_D = 4, 6, 3, 16
# The meshes of the 2- and 4-rank runs, with the axis each run uses.
TP_MESHES = {4: ((4,), ("model",)), 2: ((2, 2), ("data", "model"))}
DP_MESHES = {4: ((4,), ("dp",)), 2: ((2, 2), ("rep", "dp"))}
RESTORE_MESHES = {"fsdp_tp": ((2, 2), ("data", "model")),
                  "data": ((4,), ("data",))}


def tp_inputs(case):
    """x, w_up, w_down of a TP MLP case, f32, from seed 0."""
    shape, d, f = TP_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w_up = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)
    return x, w_up, w_down


def psum_inputs(n):
    """Every rank's gradient and error buffer [n, ...], f32, seed n."""
    rng = np.random.default_rng(n)
    g = rng.normal(size=(n,) + PSUM_SHAPE).astype(np.float32)
    err = (rng.normal(size=(n,) + PSUM_SHAPE) * 1e-3).astype(np.float32)
    return g, err


def ef_inputs(n):
    """The reference test's constant gradients for error feedback."""
    return np.random.default_rng(1).normal(size=(n,) + EF_SHAPE).astype(
        np.float32)


def pipe_inputs():
    """The reference test's stage weights [4, 16, 16] and microbatches
    [6, 3, 16]."""
    rng = np.random.default_rng(0)
    ws = rng.normal(size=(PIPE_STAGES, PIPE_D, PIPE_D)).astype(
        np.float32) * 0.5
    xs = rng.normal(size=(PIPE_MICRO, PIPE_MB, PIPE_D)).astype(np.float32)
    return ws, xs


def stage_fn(w, x):
    return torch.tanh(x @ w)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tp(mesh):
    out = {}
    for case in TP_CASES:
        x, w_up, w_down = (torch.from_numpy(a) for a in tp_inputs(case))
        wire = {}
        y = tp_matmul.tp_mlp_block(mesh, x, w_up, w_down, wire=wire)
        out[case] = {"y": _np(y), "codes": _np(wire["codes"]),
                     "scales": _np(wire["scales"]),
                     "partial": tuple(wire["partial"].shape)}
    return out


def _psum(mesh, n):
    index = mesh.index("dp")
    g, err = psum_inputs(n)
    out = {}
    for bits in (8, 2):
        mean, new_err = compression.compressed_psum(
            torch.from_numpy(g[index]), torch.from_numpy(err[index]),
            mesh=mesh, axis_name="dp", bits=bits)
        out[bits] = (mean.numpy(), new_err.numpy())
    ge = torch.from_numpy(ef_inputs(n)[index])
    e = compression.init_error_feedback({"g": ge})
    acc = torch.zeros(EF_SHAPE)
    for _ in range(EF_ROUNDS):
        mean, e = compression.compressed_psum_tree({"g": ge}, e, mesh=mesh,
                                                   axis_name="dp")
        acc = acc + mean["g"]
    out["ef"] = acc.numpy()
    return out


def _pipe(mesh):
    ws, xs = (torch.from_numpy(a) for a in pipe_inputs())
    got = pipeline.run_pipeline(mesh, stage_fn, ws, xs)
    want = []
    for mb in xs:                         # one microbatch at a time
        for s in range(PIPE_STAGES):
            mb = stage_fn(ws[s], mb)
        want.append(mb)
    return {"got": got.numpy(), "sequential": torch.stack(want).numpy()}


def _blocks(tree, mesh):
    """This rank's blocks of ``tree`` under the training rules, as
    ``{path: numpy}``."""
    specs = rules.tree_shardings(mesh, tree)
    blocks = rules.shard_tree(tree, specs, mesh=mesh)
    return {p: _np(t) for p, t in rules.leaf_paths(blocks).items()}


def run_all(rank, state_file, ckpt_dir):
    """Every run of the module on this rank; results by key."""
    out = {}
    meshes = {}
    for n, (shape, axes) in TP_MESHES.items():
        mesh = meshes[(shape, axes)] = make_mesh(shape, axes, device="cpu")
        out[("coords", shape)] = mesh.coords
        out[("tp", n)] = _tp(mesh)
    for n, (shape, axes) in DP_MESHES.items():
        out[("psum", n)] = _psum(make_mesh(shape, axes, device="cpu"), n)
    out["pipe"] = _pipe(make_mesh((4,), ("stage",), device="cpu"))
    state = torch.load(state_file)
    out["blocks"] = _blocks(state, meshes[TP_MESHES[2]])
    stacked = convert.stack_layers(state)
    for label, (shape, axes) in RESTORE_MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        got = ckpt.restore(ckpt_dir, 1, stacked,
                           sharding_fn=rules.restore_block_fn(mesh))[0]
        out[("restore", label)] = {p: _np(t) for p, t in
                                   rules.leaf_paths(got).items()}
    try:
        make_mesh((2, 4), ("data", "model"), device="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out


def gpu_rank(rank):
    """tests/test_torch_gpu.py's rank: the "3d" TP case on a 2-rank
    ("model",) mesh sharing the card; returns the wire's codes and scales
    and the act-quant kernel's launches."""
    from repro_torch.kernels import _build
    mesh = make_mesh((2,), ("model",), device="cuda")
    x, w_up, w_down = (torch.from_numpy(a).cuda() for a in tp_inputs("3d"))
    _build.reset_launches()
    wire = {}
    y = tp_matmul.tp_mlp_block(mesh, x, w_up, w_down, wire=wire)
    torch.cuda.synchronize()
    return {"codes": _np(wire["codes"].cpu()),
            "scales": _np(wire["scales"].cpu()),
            "y": _np(y.cpu()), "launches": _build.LAUNCHES["act_quant"]}
