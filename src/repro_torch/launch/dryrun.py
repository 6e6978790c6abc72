"""Multi-pod dry-run (port of ``repro.launch.dryrun``): reckon every (arch x
shape x mesh) cell on the production mesh from shapes alone; record the
memory, cost and collective figures the roofline reads
(``launch.roofline``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k [--multi-pod] [--reduced] [--kv-bits 8]

The reference lowers and compiles the step with XLA on 512 placeholder
host devices and reads the per-partition program.  Torch has no
partitioner, so the port runs the same step eagerly on ``meta`` tensors
(shapes only, nothing allocated) at the cell's GLOBAL shapes, counts it
with ``launch.hlo_cost``, and reads the per-device figures from the
sharding rules (``distributed.sharding_rules``) on an unbound mesh
(``launch.mesh.make_production_mesh``; ``--reduced``: 2 x 2).  Nothing
creates a process group.

Per device:
  * ``flops``, ``bytes_accessed`` and ``memory.temp_size_in_bytes``: the
    global step's counts (``temp``: its peak of live bytes) over
    ``n_devices``, the even split the rules' sharding gives.  XLA's
    per-partition figure also counts compute that stays replicated and,
    in train cells, the reference's layer remat (``jax.checkpoint`` of
    every layer body re-runs its forward in the backward; the port's eager
    autograd does not, so its train flops are lower by one forward of the
    layers).
  * ``memory.argument_size_in_bytes``: the rules' blocks
    (``block_bytes``) of the params, AdamW state and batch (train), or of
    the prepared store, caches and tokens (serve).
  * ``memory.output_size_in_bytes``: what the step returns: the new state
    and the metrics (train), the logits (batch over the batch axes, vocab
    over "model", as the head's rule leaves them) and the caches (serve).
    XLA's figure also holds the output tuple's index table, 8 B a leaf.
  * ``memory.alias_size_in_bytes``: the donated part of the output: the
    state (train), the caches (serve), as the reference donates them.
  * ``min_bytes_accessed``: the least a step must move, independent of
    the op trace: every argument block read once, every output block
    written once, where a donated KV cache counts only the positions the
    step writes (a decode step: one of ``seq_len``); the roofline's
    memory bound (``launch.roofline``).
  * ``collectives``: reckoned from the rules (a leaf's blocks and the
    axes its spec names), not from a compiled graph: a model of FSDP x TP
    (Megatron-style) that will not equal XLA's figure.  The residual
    stream is cut over the batch axes only, so a device holds
    ``tokens / batch group`` rows of it, the same rows as every device of
    its "model" group.
      - Weights: a leaf's "model" axis is TP (or EP): a device computes on
        that shard as it is.  Its other axes are FSDP: the shard is
        all-gathered over them once a step (operand: the device's block).
        In train cells the gradient is reduce-scattered back to the block
        over the FSDP axes (operand: the TP shard), then all-reduced over
        the rest of the batch axes (the pod axis, or "data" for a leaf
        FSDP does not cut; operand: the block).
      - Activations: a block whose output projection "model" cuts on its
        contraction side (attention's ``o_proj``, an MLP's or MoE's
        ``down_proj``, the SSM's ``out_proj``; an expert bank cut on its
        expert dim as well) leaves partial sums: one all-reduce of the
        block's output rows [tokens / batch group, d_model] over "model"
        in the forward, and in train cells one more of the same size in
        the backward (the conjugate, at the block's input).  EP's dispatch
        moves nothing, since every device of a "model" group already holds
        its tokens; its combine is that all-reduce.  The embedding (vocab
        over "model") adds a forward one where tokens are looked up; the
        head (vocab over "model") a backward one in train cells.  The
        softmax statistics of a vocab-sharded loss or of a
        sequence-sharded cache (a few floats a row) are not modelled.
    ``f32_bytes`` is the f32 share.

Keys of the reference's result that change meaning: ``lower_s`` is the
time to build the meta trees, ``compile_s`` the time to count the step,
``hlo_lines`` the number of ops dispatched; ``xla_cost_raw``,
``collectives_unscaled`` and ``memory.generated_code_size_in_bytes`` are
dropped; ``min_bytes_accessed`` is the port's own.  ``--dump-hlo`` writes the per-op table (aten op, calls, flops,
bytes; gzip-compressed tab-separated text) as ``<stem>.ops.tsv.gz``.
``--backend`` takes the port's names; ``cuda`` is refused: the
hand-written kernels cannot launch on meta tensors, and ``decomposed``
runs the same integer arithmetic.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import uniform_policy
from repro_torch.distributed import sharding_rules as rules
from repro_torch.distributed.sharding import axis_size, resolve_axis
from repro_torch.launch import hlo_cost
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import prepare_params
from repro_torch.train import optimizer as optim
from repro_torch.train.step import make_serve_steps, make_train_step

BACKENDS = ("dense", "fake_quant", "decomposed")
CUDA_REFUSED = ("--backend cuda: the hand-written kernels cannot launch on "
                "meta tensors; use --backend decomposed, which runs the "
                "same integer arithmetic")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _reduced_mesh() -> Mesh:
    return Mesh(shape=(2, 2), axis_names=("data", "model"))


def _batch_group(mesh: Mesh, batch: int) -> int:
    """The number of blocks the batch axes cut a batch of ``batch`` into."""
    return axis_size(mesh, rules.batch_spec(mesh, (batch,))[0])


# The blocks a TP region spans, and the projections that close one.
_BLOCKS = ("attn", "mlp", "moe", "mamba")
_CLOSERS = ("o_proj", "down_proj", "out_proj")


def _region(path: str, leaf: Any, spec: Any, model: Any) -> Optional[str]:
    """The TP region whose partial sums ``leaf`` (at ``path``, cut by
    ``spec``) leaves, or None: "embed", "lm_head", or the block's path
    (``layers.0.pos0.attn``; a shared expert belongs to its MoE block)."""
    cut = [i for i, a in enumerate(spec) if a == model]
    if not cut:
        return None
    parts = path.split(".")
    if parts[0] in ("embed", "lm_head"):
        return parts[0]
    for i, part in enumerate(parts):
        if part in _BLOCKS:
            closes = any(p in _CLOSERS for p in parts[i + 1:])
            # Cut on a dim other than the output's: partial sums.
            partial = cut[0] != leaf.ndim - 1
            return ".".join(parts[:i + 1]) if closes and partial else None
    return None


def reckon_collectives(tree: Any, specs: Dict[str, Any], mesh: Mesh, *,
                       train: bool, batch: int, tokens: int, row_bytes: int,
                       lookup: bool) -> hlo_cost.Cost:
    """The collectives of one step over ``tree`` under ``specs`` (the
    module docstring's FSDP x TP model), per device.  ``tokens``: the
    step's global token count; ``row_bytes``: one residual-stream row
    (d_model activations); ``lookup``: the step looks tokens up in the
    embedding."""
    cost = hlo_cost.Cost()
    model = resolve_axis(mesh, "model")
    data_parallel = _batch_group(mesh, batch)
    regions = set()
    for path, leaf in rules.leaf_paths(tree).items():
        spec = specs[path]
        tp = math.prod(axis_size(mesh, a) for a in spec if a == model)
        fsdp = math.prod(axis_size(mesh, a) for a in spec if a != model)
        if tp > 1:
            region = _region(path, leaf, spec, model)
            if region is not None:
                regions.add(region)
        # The TP (or EP) shard a device computes on.
        local = leaf.numel() * leaf.element_size() / tp
        f32 = leaf.dtype == torch.float32
        if fsdp > 1:
            cost.add_collective("all-gather", local, fsdp, f32=f32)
        if not train:
            continue
        if fsdp > 1:
            cost.add_collective("reduce-scatter", local / fsdp, fsdp,
                                f32=f32)
        if data_parallel > fsdp:
            cost.add_collective("all-reduce", local / fsdp,
                                data_parallel // fsdp, f32=f32)
    rows = tokens // data_parallel * row_bytes
    group = axis_size(mesh, model)
    for region in sorted(regions):
        forward = region != "lm_head" and (region != "embed" or lookup)
        backward = train and region != "embed"
        for _ in range(forward + backward):
            cost.add_collective("all-reduce", rows, group)
    return cost


def _logits_bytes(mesh: Mesh, logits: torch.Tensor) -> int:
    """A device's logits [B, 1, V]: batch over the batch axes, vocab over
    "model" (each where it divides)."""
    model = resolve_axis(mesh, "model")
    vocab = axis_size(mesh, model) \
        if logits.shape[-1] % axis_size(mesh, model) == 0 else 1
    return logits.numel() * logits.element_size() \
        // (_batch_group(mesh, logits.shape[0]) * vocab)


# Cache leaves with one entry per position: a step writes only its own.
_KV_LEAVES = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass
class Cell:
    """One built cell: the step and its inputs (on meta, or on the device
    ``build_cell`` was given), and the per-device argument, output and
    collective reckonings' inputs."""
    step: Any
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    arg_bytes: int
    donated: Any            # the argument the step donates
    donated_specs: Dict[str, Any]
    gathered: Any           # the tree whose leaves are gathered
    gathered_specs: Dict[str, Any]
    mesh: Mesh
    tokens: int             # the step's global tokens
    row_bytes: int          # one residual-stream row
    lookup: bool            # tokens are looked up in the embedding
    kv_written: float       # the share of a KV cache's positions written


def _config(arch: Union[str, ArchConfig], reduced: bool) -> ArchConfig:
    if isinstance(arch, ArchConfig):
        return arch
    return reduced_config(arch) if reduced else get_config(arch)


def _shape(shape: Union[str, specs_mod.ShapeSpec],
           reduced: bool) -> specs_mod.ShapeSpec:
    if isinstance(shape, str):
        shape = specs_mod.SHAPES[shape]
    if reduced:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 128),
            global_batch=min(shape.global_batch, 8))
    return shape


def _inputs(tree: Dict[str, torch.Tensor], cfg: ArchConfig,
            gen: torch.Generator, dev: torch.device
            ) -> Dict[str, torch.Tensor]:
    """``specs``' stand-ins as tensors on ``dev`` (token ids below the
    vocab, embeddings from a normal); on meta, the stand-ins."""
    if dev.type == "meta":
        return tree
    return {k: torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=dev, dtype=t.dtype)
            if not t.dtype.is_floating_point else
            torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)
            for k, t in tree.items()}


def build_cell(arch: Union[str, ArchConfig],
               shape_name: Union[str, specs_mod.ShapeSpec], *,
               multi_pod: bool, backend: Optional[str], w_bits: int,
               a_bits: int, kv_bits: Optional[int], reduced: bool,
               moment_dtype: str = "bfloat16", packed: bool = False,
               accum: int = 1, mesh: Optional[Mesh] = None,
               device: Any = "meta"):
    """Returns (cell, meta) or (None, skip_reason).  ``arch`` is a name or
    a config, ``shape_name`` a name or a ``ShapeSpec`` and ``mesh`` (if
    given) replaces the production or reduced mesh.  ``device``: where the
    trees live (meta: shapes only; elsewhere weights and inputs are drawn
    from seed 0, so the same step runs for real)."""
    if backend == "cuda":
        raise ValueError(CUDA_REFUSED)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"--backend {backend}: not one of {BACKENDS}")
    cfg = _config(arch, reduced)
    shape = _shape(shape_name, reduced)
    ok, reason = specs_mod.cell_applicable(cfg, shape)
    if not ok:
        return None, reason
    model = LM(cfg)
    if mesh is None:
        mesh = _reduced_mesh() if reduced else \
            make_production_mesh(multi_pod=multi_pod)
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(0)
    params = model.init(gen, device=dev)
    b = shape.global_batch
    row_bytes = cfg.d_model * cfg.dtype.itemsize
    if shape.kind == "train":
        be = backend or "fake_quant"
        rt = Runtime(policy=uniform_policy(w_bits, a_bits, backend=be))
        ocfg = optim.OptConfig(moment_dtype=moment_dtype)
        state = {"params": params, "opt": optim.init_state(params, ocfg)}
        state_sh = rules.tree_shardings(mesh, state)
        batch = _inputs(specs_mod.batch_specs(cfg, shape), cfg, gen, dev)
        batch_sh = rules.batch_shardings(mesh, batch)
        cell = Cell(
            step=make_train_step(model, rt, ocfg, accum_steps=accum),
            args=(state, batch), kwargs={},
            arg_bytes=rules.block_bytes(state, state_sh, mesh)
            + rules.block_bytes(batch, batch_sh, mesh),
            donated=state, donated_specs=state_sh, gathered=params,
            gathered_specs=rules.tree_shardings(mesh, params), mesh=mesh,
            tokens=b * shape.seq_len, row_bytes=row_bytes,
            lookup="tokens" in batch, kv_written=1.0)
    else:
        be = backend or "decomposed"
        rt = Runtime(policy=uniform_policy(w_bits, a_bits, backend=be))
        prefill_fn, decode_fn = make_serve_steps(model, rt)
        if be == "decomposed":
            # Offline weight preparation: planes preloaded like the array.
            params = prepare_params(params, rt.policy, model,
                                    packed=packed)[0]
        p_sh = rules.tree_shardings(mesh, params)
        caches = model.init_cache(b, shape.seq_len, kv_bits=kv_bits,
                                  device=dev)
        c_sh = rules.cache_shardings(mesh, caches)
        seq = shape.seq_len if shape.kind == "prefill" else 1
        tok = _inputs(specs_mod.token_specs(cfg, b, seq), cfg, gen, dev)
        tok_sh = rules.batch_shardings(mesh, tok)
        cell = Cell(
            step=prefill_fn if shape.kind == "prefill" else decode_fn,
            args=(params, caches), kwargs=tok,
            arg_bytes=rules.block_bytes(params, p_sh, mesh)
            + rules.block_bytes(caches, c_sh, mesh)
            + rules.block_bytes(tok, tok_sh, mesh),
            donated=caches, donated_specs=c_sh,
            gathered=params, gathered_specs=p_sh, mesh=mesh,
            tokens=b * seq, row_bytes=row_bytes, lookup="tokens" in tok,
            kv_written=seq / shape.seq_len)

    meta = {
        "arch": cfg.name, "family": cfg.family, "shape": shape.name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "mesh": mesh_name(mesh),
        "axes": list(mesh.axis_names),
        "n_devices": int(mesh.n),
        "backend": be, "w_bits": w_bits, "a_bits": a_bits,
        "kv_bits": kv_bits, "packed": packed, "accum": accum,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "model_flops": specs_mod.model_flops(cfg, shape),
    }
    return cell, meta


def _output_bytes(cell: Cell, out: Any, train: bool) -> Tuple[int, int]:
    """(output, alias) bytes per device of the step's result ``out``."""
    mesh = cell.mesh
    alias = rules.block_bytes(cell.donated, cell.donated_specs, mesh)
    if train:
        _, metrics = out
        rest = sum(m.numel() * m.element_size() for m in metrics.values())
    else:
        rest = _logits_bytes(mesh, out[0])
    return alias + rest, alias


def _written_bytes(cell: Cell) -> float:
    """The bytes of the donated blocks a step writes: all of a train
    state; of a KV cache only the positions it fills."""
    total = 0.0
    for path, leaf in rules.leaf_paths(cell.donated).items():
        blocks = math.prod(axis_size(cell.mesh, a)
                           for a in cell.donated_specs[path])
        nbytes = leaf.numel() * leaf.element_size() // blocks
        if path.rsplit(".", 1)[-1] in _KV_LEAVES:
            nbytes *= cell.kv_written
        total += nbytes
    return total


def _write_ops(path: str, mode: hlo_cost.CostMode) -> None:
    with gzip.open(path, "wt") as f:
        f.write("op\tcalls\tflops\tbytes\n")
        for name, (calls, flops, nbytes) in sorted(
                mode.ops.items(), key=lambda kv: -kv[1][2]):
            f.write(f"{name}\t{calls}\t{flops:.0f}\t{nbytes:.0f}\n")


def run_cell(arch: Union[str, ArchConfig],
             shape_name: Union[str, specs_mod.ShapeSpec], *,
             multi_pod: bool = False, backend: Optional[str] = None,
             w_bits: int = 4, a_bits: int = 8, kv_bits: Optional[int] = None,
             reduced: bool = False, dump_hlo: Optional[str] = None,
             packed: bool = False, accum: int = 1,
             mesh: Optional[Mesh] = None,
             moment_dtype: str = "bfloat16") -> Dict[str, Any]:
    t0 = time.time()
    cell, meta = build_cell(arch, shape_name, multi_pod=multi_pod,
                            backend=backend, w_bits=w_bits, a_bits=a_bits,
                            kv_bits=kv_bits, reduced=reduced, packed=packed,
                            accum=accum, mesh=mesh,
                            moment_dtype=moment_dtype)
    if cell is None:
        name = mesh_name(mesh) if mesh is not None else \
            ("2x16x16" if multi_pod else "16x16")
        return {"arch": arch if isinstance(arch, str) else arch.name,
                "shape": shape_name if isinstance(shape_name, str)
                else shape_name.name,
                "mesh": name, "skipped": True, "reason": meta}
    t_lower = time.time() - t0
    out, mode = hlo_cost.count(cell.step, *cell.args, **cell.kwargs)
    t_compile = time.time() - t0 - t_lower

    n = meta["n_devices"]
    train = meta["kind"] == "train"
    out_bytes, alias = _output_bytes(cell, out, train)
    mem = {"argument_size_in_bytes": cell.arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": mode.peak_bytes // n,
           "alias_size_in_bytes": alias}
    print("memory_analysis:", json.dumps(mem))
    cost = mode.cost
    print("cost_analysis: flops=%s bytes=%s" % (cost.flops, cost.bytes))
    coll = reckon_collectives(cell.gathered, cell.gathered_specs, cell.mesh,
                              train=train, batch=meta["global_batch"],
                              tokens=cell.tokens, row_bytes=cell.row_bytes,
                              lookup=cell.lookup)
    if dump_hlo:
        _write_ops(dump_hlo, mode)

    res = dict(meta)
    res.update({
        "skipped": False,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "flops": cost.flops / n,
        "bytes_accessed": cost.bytes / n,
        "min_bytes_accessed": cell.arg_bytes + out_bytes - alias
        + _written_bytes(cell),
        "collectives": coll.as_dict()["collectives"],
        "memory": mem,
        "hlo_lines": mode.n_ops,
    })
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=sorted(specs_mod.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default=None,
                    choices=list(BACKENDS) + ["cuda"])
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--kv-bits", type=int, default=None)
    ap.add_argument("--packed", action="store_true",
                    help="packed plane layout (w_bits/8 bytes per weight)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny config on a 2x2 mesh (CI / self-test)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--dump-hlo", action="store_true",
                    help="write the per-op table (<stem>.ops.tsv.gz)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.backend == "cuda":
        ap.error(CUDA_REFUSED)

    os.makedirs(args.out, exist_ok=True)
    mesh = ("2x16x16" if args.multi_pod else "16x16") if not args.reduced \
        else "2x2"
    stem = f"{args.arch}__{args.shape}__{mesh}"
    if args.backend:
        stem += f"__{args.backend}"
    if args.tag:
        stem += f"__{args.tag}"
    ops_path = os.path.join(args.out, stem + ".ops.tsv.gz") \
        if args.dump_hlo else None

    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   backend=args.backend, w_bits=args.w_bits,
                   a_bits=args.a_bits, kv_bits=args.kv_bits,
                   reduced=args.reduced, dump_hlo=ops_path,
                   packed=args.packed, accum=args.accum)
    out_path = os.path.join(args.out, stem + ".json")
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    status = "SKIP" if res.get("skipped") else "OK"
    print(f"[{status}] {stem} -> {out_path}")
    if not res.get("skipped"):
        print(f"  count={res['compile_s']}s flops={res['flops']:.3e} "
              f"coll={res['collectives']['total_bytes']:.3e}B")


if __name__ == "__main__":
    main()
