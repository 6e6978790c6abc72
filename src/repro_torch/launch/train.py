"""QAT training command line (port of ``repro.launch.train``): AdamW,
gradient accumulation and checkpoints with auto-resume, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --steps 100 --w-bits 4 --ckpt-dir /tmp/run1

The flags and printed lines are the reference's, plus ``--device``
(default ``cuda``; ``cpu`` runs the same code on the host).  Weights are
drawn from a torch generator seeded 0 on that device.  Checkpoints hold
``{"params", "opt"}`` in the reference's on-disk layout (the layers
stacked into ``periods``, the reference's leaf names, the ``step`` scalar
and ``extra={"data_step"}``), so either package resumes the other's run.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import stack_layers, unstack_layers
from repro_torch.core.policy import uniform_policy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as optim
from repro_torch.train.step import make_train_step


def checkpoint_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """A train state in the reference's layout, on the host."""
    return stack_layers(state, device="cpu")


def restore_state(directory: str, step: int, state: Dict[str, Any],
                  device: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The train state saved at ``step``, in the structure of ``state``
    (which only gives the tree, shapes and dtypes), on ``device``.
    Returns (state, the checkpoint's ``extra``)."""
    def meta(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    template = stack_layers(optim.tree_map(meta, state))
    tree, extra = ckpt.restore(directory, step, template, device=device)
    return unstack_layers(tree), extra


def main(argv: Optional[list] = None,
         init_params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Parse ``argv``, train and return the final train state.
    ``init_params`` (a params tree of the configured model) replaces the
    seeded initialisation, e.g. weights converted from the reference."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param example)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--backend", default="fake_quant")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    overrides: Dict[str, Any] = {}
    if args.d_model:
        heads = max(4, args.d_model // 128)
        overrides.update(d_model=args.d_model, num_heads=heads,
                         num_kv_heads=max(1, heads // 4),
                         head_dim=args.d_model // heads,
                         d_ff=args.d_model * 3)
    if args.layers:
        period = len(cfg.period_pattern())
        overrides["num_layers"] = max(period, args.layers // period * period)
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    model = LM(cfg)
    rt = Runtime(policy=uniform_policy(args.w_bits, args.a_bits,
                                       backend=args.backend))
    ocfg = optim.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)
    step_fn = make_train_step(model, rt, ocfg, accum_steps=args.accum)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch,
        embed_dim=cfg.d_model if cfg.frontend != "none" else 0))

    if init_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen, device=dev)
    else:
        params = optim.tree_map(lambda t: t.to(dev), init_params)
    n_params = sum(x.numel() for x in optim.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"w{args.w_bits}a{args.a_bits} backend={args.backend}")

    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    start = 0
    checkpointer = None
    if args.ckpt_dir:
        checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:                  # fault-tolerant auto-resume
            state, extra = restore_state(args.ckpt_dir, latest, state, dev)
            start = extra["data_step"]
            print(f"auto-resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i).items()}
        if cfg.frontend != "none":
            batch.pop("tokens", None)
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i == start:
            dt = (time.time() - t0) / max(i - start + 1, 1)
            print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"lr={float(metrics['lr']):.2e} {dt:.2f}s/step",
                  flush=True)
        if checkpointer and (i + 1) % args.ckpt_every == 0:
            checkpointer.save(i + 1, checkpoint_tree(state),
                              extra={"data_step": i + 1})
    if checkpointer:
        checkpointer.save(args.steps, checkpoint_tree(state),
                          extra={"data_step": args.steps})
        checkpointer.wait()
    print("done")
    return state


if __name__ == "__main__":
    main()
