"""Train and serve step factories (port of ``repro.train.step``).

The train step is QAT through the ``fake_quant`` backend: every
projection quantize-dequantizes its weight and input and runs a bf16
``torch.matmul``, as the reference does outside any Pallas kernel, and
``torch.autograd`` takes the gradients.  The reference's ``shard`` hints
place tensors on a mesh; on one device they are the identity, and the
port has none.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as optim
from repro_torch.train.optimizer import tree_leaves, tree_map

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32.  logits: [B, S, V] (any float dtype)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.to(torch.int64)[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def make_loss_fn(model: LM, rt: Runtime, aux_weight: float = 0.01
                 ) -> Callable[[Any, Batch], Tuple[torch.Tensor, Metrics]]:
    def loss_fn(params: Any, batch: Batch) -> Tuple[torch.Tensor, Metrics]:
        logits, aux = model.forward(
            params, rt,
            tokens=batch.get("tokens") if "embeds" not in batch else None,
            embeds=batch.get("embeds"))
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        loss = ce + aux_weight * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn: Callable[[Any, Batch],
                                     Tuple[torch.Tensor, Metrics]],
                   params: Any, batch: Batch) -> Tuple[Metrics, Any]:
    """(metrics, gradients) of ``loss_fn(params, batch)``, the gradients a
    tree like ``params`` (zeros where the loss does not reach a leaf, as
    ``jax.grad`` gives, e.g. the embedding table under ``embeds=``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)}
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], leaves))


def make_train_step(model: LM, rt: Runtime, opt_cfg: optim.OptConfig,
                    accum_steps: int = 1, aux_weight: float = 0.01
                    ) -> Callable[[Dict[str, Any], Batch],
                                  Tuple[Dict[str, Any], Metrics]]:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}.  With accum_steps > 1 the batch's
    leading dim is split into microbatches whose gradients are summed in
    f32 and scaled by 1/accum_steps (gradient accumulation)."""
    loss_fn = make_loss_fn(model, rt, aux_weight)

    def compute_grads(params: Any, batch: Batch) -> Tuple[Any, Metrics]:
        if accum_steps == 1:
            metrics, grads = value_and_grad(loss_fn, params, batch)
            return grads, metrics
        micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                              *v.shape[1:]) for k, v in batch.items()}
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        m_acc: Optional[Metrics] = None
        for i in range(accum_steps):
            metrics, grads = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in micro.items()})
            g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, grads)
            del grads
            if m_acc is None:
                m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
            m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
        inv = 1.0 / accum_steps
        return (tree_map(lambda g: g * inv, g_acc),
                {k: m * inv for k, m in m_acc.items()})

    def train_step(state: Dict[str, Any], batch: Batch
                   ) -> Tuple[Dict[str, Any], Metrics]:
        grads, metrics = compute_grads(state["params"], batch)
        params, opt, opt_metrics = optim.apply_updates(
            state["params"], grads, state["opt"], opt_cfg)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_serve_steps(model: LM, rt: Runtime):
    """Returns (prefill_fn, decode_fn) over the model's caches:
    decode_fn(params, caches, tokens|embeds) -> (logits [B, 1, V], caches)."""

    def prefill_fn(params: Any, caches: Any,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None):
        return model.prefill(params, rt, caches, tokens=tokens, embeds=embeds)

    def decode_fn(params: Any, caches: Any,
                  tokens: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None):
        return model.decode_step(params, rt, caches, tokens=tokens,
                                 embeds=embeds)

    return prefill_fn, decode_fn
