"""AdamW with schedule, clipping and a configurable moment dtype (port of
``repro.train.optimizer``).

Parameters, gradients and the moments are nested dicts and lists of
tensors of one structure (the port's per-layer ``params["layers"]``).
The update is the reference's elementwise f32 arithmetic, op for op, with
every scalar of the step (``lr``, the bias corrections, the clip factor)
an f32 tensor on the parameters' device: on CUDA, PyTorch turns a
division by a Python number into a multiply by its reciprocal, which the
reference does not do.  ``moment_dtype="bfloat16"`` stores the moments in
bf16 (the update itself still runs in f32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"       # float32 | bfloat16


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples of the same
    structure (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _f32(value: float, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _inv(n: int, device: torch.device) -> torch.Tensor:
    """1/n rounded to f32, the constant XLA multiplies by where the
    reference divides by a constant under ``jit``."""
    return _f32(float(np.float32(1) / np.float32(n)), device)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; ``step`` a 0-dim
    tensor, the result an f32 tensor on its device.  The two divisions
    by constants are the reciprocal multiplies the jitted reference runs
    (it differs from the division by up to a few ulps)."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.minimum(_f32(1.0, dev),
                         (step + 1) * _inv(max(cfg.warmup_steps, 1), dev))
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        * _inv(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, dev) * prog))
    return cfg.lr * warm * cos


def bias_corrections(cfg: OptConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1**t, 1 - b2**t) at t = step + 1, f32 tensors."""
    dev = step.device
    t = (step + 1).to(torch.float32)
    return (1 - torch.pow(_f32(cfg.b1, dev), t),
            1 - torch.pow(_f32(cfg.b2, dev), t))


def init_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: OptConfig) -> Tuple[Any, Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"]
    gnorm = global_norm(grads)
    clip = torch.minimum(_f32(1.0, gnorm.device),
                         _f32(cfg.grad_clip, gnorm.device) / (gnorm + 1e-9))
    lr = lr_at(cfg, step)
    bc1, bc2 = bias_corrections(cfg, step)

    def upd(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        g = g.to(torch.float32) * clip
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g * g
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        # Decoupled weight decay on matrices only (ndim >= 2).
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p32 = p.to(torch.float32)
        newp = p32 - lr * (update + wd * p32)
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step + 1}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every 3-tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
