"""Float weights made from ``--seed`` on the device, in the serving
engine's parameter layout (``params["layers"][i]["pos0"]["attn"]["q_proj"]
["w"]``, ``[K, N]`` so that ``y = x @ w``), in the type they are served in.

Each part has a generator of its own, seeded from (seed, part, layer), so
the reference can make any one layer again after the window without the
rest.  A layer is a few large draws: one uniform draw for all its matrices
(scaled in place to ``U(-1/sqrt(K), 1/sqrt(K))``) and one for its vectors.
Imports nothing of the program: the reference uses it too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_PART = {"embed": 1, "layer": 2, "head": 3, "final": 4}


def generator(seed: int, part: str, index: int,
              device: torch.device) -> torch.Generator:
    """The generator of one part of the weights."""
    state = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), _PART[part], index]).generate_state(
            2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 32 | int(state[1])) & (2**63 - 1))
    return g


def padded_vocab(cfg: Dict[str, Any]) -> int:
    """The engine's vocabulary rows: a multiple of 256."""
    return -(-int(cfg["vocab_size"]) // 256) * 256


def _matrices(cfg: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], int, int]]:
    """(key path inside the layer, K, N) of every matrix of one layer."""
    d = cfg["d_model"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * d
        ns, h = cfg["ssm_state"], di // cfg["ssm_headdim"]
        return [(("mamba", "in_proj"), d, 2 * di + 2 * ns + h),
                (("mamba", "out_proj"), di, d)]
    hq = cfg["num_heads"] * cfg["head_dim"]
    hk = cfg["num_kv_heads"] * cfg["head_dim"]
    ff = cfg["d_ff"]
    return [(("attn", "q_proj"), d, hq), (("attn", "k_proj"), d, hk),
            (("attn", "v_proj"), d, hk), (("attn", "o_proj"), hq, d),
            (("mlp", "gate_proj"), d, ff), (("mlp", "up_proj"), d, ff),
            (("mlp", "down_proj"), ff, d)]


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _gains(u: torch.Tensor) -> torch.Tensor:
    """Norm gains near 1 from uniforms: 1 + (u - 0.5) / 4."""
    return (1.0 + (u.to(torch.float32) - 0.5) * 0.25).to(torch.bfloat16)


def make_layer(cfg: Dict[str, Any], seed: int, i: int,
               device: torch.device) -> Dict[str, Any]:
    """Layer ``i`` as the engine's ``{"pos0": {...}}`` period."""
    g = generator(seed, "layer", i, device)
    mats = _matrices(cfg)
    total = sum(k * n for _, k, n in mats)
    buf = torch.rand((total,), generator=g, device=device,
                     dtype=torch.bfloat16)
    blk: Dict[str, Any] = {}
    off = 0
    for path, k, n in mats:
        w = buf[off:off + k * n].view(k, n)
        s = 1.0 / math.sqrt(k)
        w.mul_(2.0 * s).sub_(s)
        _set(blk, path + ("w",), w)
        off += k * n
    d = cfg["d_model"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * d
        ns, h = cfg["ssm_state"], di // cfg["ssm_headdim"]
        ch, width = di + 2 * ns, cfg["ssm_conv"]
        vec = torch.rand((d + di + width * ch + ch + 3 * h,), generator=g,
                         device=device, dtype=torch.float32)
        parts = torch.split(vec, [d, di, width * ch, ch, h, h, h])
        lim = 1.0 / math.sqrt(width)
        dt = torch.exp(math.log(1e-3) + parts[5] * math.log(100.0))
        blk["mixer_norm"] = {"g": _gains(parts[0])}
        blk["mamba"].update({
            "norm": {"g": _gains(parts[1])},
            "conv_w": ((parts[2] * 2.0 - 1.0) * lim).view(width, ch)
            .to(torch.bfloat16),
            "conv_b": ((parts[3] - 0.5) * 0.2).to(torch.bfloat16),
            "A_log": torch.log(1.0 + 15.0 * parts[4]),
            # dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "D": 0.5 + parts[6],
        })
    else:
        dh = cfg["head_dim"]
        vec = torch.rand((2 * d + 2 * dh,), generator=g, device=device,
                         dtype=torch.float32)
        nm, fn, qn, kn = torch.split(vec, [d, d, dh, dh])
        blk["mixer_norm"] = {"g": _gains(nm)}
        blk["ff_norm"] = {"g": _gains(fn)}
        if cfg.get("qk_norm"):
            blk["attn"]["q_norm"] = {"g": _gains(qn)}
            blk["attn"]["k_norm"] = {"g": _gains(kn)}
    return {"pos0": blk}


def make_embed(cfg: Dict[str, Any], seed: int,
               device: torch.device) -> torch.Tensor:
    """Embedding rows [padded vocab, d] bf16, N(0, s^2): s is the
    configuration's ``init.embed_std``, 1 by default.  A head tied to the
    embedding needs a small one (Mamba2 initializes it at 0.02): at 1 each
    token's own row outweighs the layers in the residual stream and the
    tied head echoes the token it was fed."""
    g = generator(seed, "embed", 0, device)
    emb = torch.randn((padded_vocab(cfg), cfg["d_model"]), generator=g,
                      device=device, dtype=torch.bfloat16)
    std = float(cfg.get("init", {}).get("embed_std", 1.0))
    return emb if std == 1.0 else emb.mul_(std)


def make_head(cfg: Dict[str, Any], seed: int,
              device: torch.device) -> torch.Tensor:
    """The LM head [d, padded vocab] bf16, ``U(-1/sqrt(d), 1/sqrt(d))``."""
    g = generator(seed, "head", 0, device)
    d = cfg["d_model"]
    w = torch.rand((d, padded_vocab(cfg)), generator=g, device=device,
                   dtype=torch.bfloat16)
    s = 1.0 / math.sqrt(d)
    return w.mul_(2.0 * s).sub_(s)


def make_final_norm(cfg: Dict[str, Any], seed: int,
                    device: torch.device) -> torch.Tensor:
    g = generator(seed, "final", 0, device)
    return _gains(torch.rand((cfg["d_model"],), generator=g, device=device,
                             dtype=torch.float32))


def make_params(cfg: Dict[str, Any], seed: int,
                device: torch.device) -> Dict[str, Any]:
    """The whole float tree the engine is handed."""
    params: Dict[str, Any] = {
        "embed": {"emb": make_embed(cfg, seed, device)},
        "layers": [make_layer(cfg, seed, i, device)
                   for i in range(cfg["num_layers"])],
        "final_norm": {"g": make_final_norm(cfg, seed, device)},
    }
    if not cfg.get("tie_embeddings"):
        params["lm_head"] = {"w": make_head(cfg, seed, device)}
    return params
