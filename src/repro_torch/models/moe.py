"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch (port
of ``repro.models.moe``).

The router stays dense, in f32.  Dispatch is per sequence, as in the
reference: each token's position within its expert comes from a cumsum of
one-hot rows, tokens past the capacity go to an overflow row, and the
kept ones are scatter-added into a ``[B, E*C + 1, d]`` buffer.  Where the
reference vmaps its expert FFN over the expert axis, the port loops over
the experts: each expert's ``[B, C, d]`` buffer goes through the unchanged
``layers.linear``, so every expert projection takes the same quantized
kernels as a dense projection (one launch per expert).  A prepared expert
weight is one stacked ``QuantizedWeight`` (planes [E, P, K, N] or packed
[E, K, N], scale [E, 1, N]) read through its per-expert views.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers


def moe_init(gen: torch.Generator, cfg, dtype: torch.dtype,
             device: torch.device) -> Dict[str, Any]:
    """The reference's distributions (the draws differ; tests convert the
    reference's weights)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return (u * (2.0 * bound) - bound).to(dtype)

    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p: Dict[str, Any] = {
        "router": {"w": torch.randn((d, e), generator=gen, device=device,
                                    dtype=torch.float32) * 0.02},
        "gate_proj": {"w": uniform((e, d, f), s_in)},
        "up_proj": {"w": uniform((e, d, f), s_in)},
        "down_proj": {"w": uniform((e, f, d), s_out)},
    }
    if cfg.shared_expert:
        p["shared"] = layers.mlp_init(gen, d, f, dtype, device)
    return p


def route(params: Dict[str, Any], x: torch.Tensor, k: int, *,
          verify_window: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 router: (probs [B, S, E], top_w [B, S, k] renormalised,
    top_i [B, S, k]).  Top-k is a stable descending sort, so a tie puts
    the lower expert first, as ``jax.lax.top_k`` does.  In a verify window
    the logits and softmax run per position (``layers.per_position``)."""
    w = params["router"]["w"]

    def probs_of(t: torch.Tensor) -> torch.Tensor:
        return layers.softmax(torch.matmul(t.to(torch.float32), w))

    probs = layers.per_position(probs_of, x) if verify_window \
        else probs_of(x)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = vals[..., :k], idx[..., :k]
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_w, top_i


def aux_loss(probs: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss: E * sum(density * mean_prob), the
    density counting each token's first choice."""
    e = probs.shape[-1]
    first = top_i[..., 0, None] == torch.arange(e, device=top_i.device)
    density = first.to(torch.float32).mean(dim=(0, 1))
    return e * torch.sum(density * probs.mean(dim=(0, 1)))


def capacity(s: int, cfg, dropless: bool) -> int:
    """Per-sequence expert capacity: ``round(s * k * cf / E)`` (Python's
    rounding, at least 1) or the whole sequence when dropless, capped at
    ``s``."""
    if dropless:
        return s
    cap = int(max(1, round(s * cfg.experts_per_token * cfg.capacity_factor
                           / cfg.num_experts)))
    return min(cap, s)


def dispatch_slots(top_i: torch.Tensor, e: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep [B, S*k] bool, slot [B, S*k]): each (token, choice)'s row in
    the ``[B, E*cap + 1]`` buffer, ``E*cap`` (the overflow row) when its
    position within its expert reaches the capacity."""
    b = top_i.shape[0]
    flat_e = top_i.reshape(b, -1)
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos_in_e = pos.gather(2, flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))
    return keep, slot


def _expert_weight(w: Any, i: int) -> Any:
    return w.expert(i) if isinstance(w, ops.QuantizedWeight) else w[i]


def _expert_ffn(params: Dict[str, Any], i: int, x: torch.Tensor,
                rt: layers.Runtime, name: str,
                verify_window: bool) -> torch.Tensor:
    """Expert ``i``'s SwiGLU on its buffer x [B, C, d].  Gate and up share
    one activation quantization of x (the codes are the same either way);
    in a verify window the activation runs per position."""
    acts: Dict[Any, Any] = {}
    gate = layers.linear({"w": _expert_weight(params["gate_proj"]["w"], i)},
                         x, rt, f"{name}.gate_proj", act_quants=acts)
    up = layers.linear({"w": _expert_weight(params["up_proj"]["w"], i)},
                       x, rt, f"{name}.up_proj", act_quants=acts)
    if verify_window:
        hidden = layers.per_position(
            lambda g, u: layers._swiglu(g, u, x.dtype), gate, up)
    else:
        hidden = layers._swiglu(gate, up, x.dtype)
    return layers.linear({"w": _expert_weight(params["down_proj"]["w"], i)},
                         hidden, rt, f"{name}.down_proj")


def moe_apply(params: Dict[str, Any], x: torch.Tensor, rt: layers.Runtime,
              cfg, name: str, *, verify_window: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block on x [B, S, d]: returns (y [B, S, d], aux), aux the
    f32 load-balancing loss (:func:`aux_loss`; zero in a verify window,
    whose caller drops it).  Dropless when ``rt.moe_dropless``.  A verify
    window is always dropless, since a decode step never drops its one
    token and each window position must equal its decode step."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dropless = verify_window or rt.moe_dropless
    probs, top_w, top_i = route(params, x, k, verify_window=verify_window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if verify_window else aux_loss(probs, top_i)
    cap = capacity(s, cfg, dropless)
    keep, slot = dispatch_slots(top_i, e, cap)

    # Dispatch: scatter-add into [B, E*cap (+1 overflow), d].
    x_rep = torch.where(keep[..., None], x.repeat_interleave(k, dim=1),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(b, s * k, d), x_rep)
    xe = buf[:, :e * cap].reshape(b, e, cap, d)
    ye = torch.stack([_expert_ffn(params, i, xe[:, i], rt, name,
                                  verify_window) for i in range(e)], dim=1)

    # Combine: each (token, choice)'s row, weighted, summed over k in f32.
    yr = torch.cat([ye.reshape(b, e * cap, d),
                    ye.new_zeros((b, 1, d))], dim=1)
    y_tok = yr[torch.arange(b, device=x.device)[:, None], slot]
    y_tok = y_tok.to(torch.float32) * top_w.reshape(b, s * k)[..., None]
    y = y_tok.reshape(b, s, k, d).sum(dim=2).to(x.dtype)
    if cfg.shared_expert:
        y = y + layers.mlp_apply(params["shared"], x, rt, f"{name}.shared",
                                 verify_window=verify_window)
    return y, aux
