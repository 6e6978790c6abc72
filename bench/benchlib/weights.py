"""Float weights made from ``--seed`` on the device, in the serving
engine's parameter layout (``params["layers"][p]["pos{j}"]["attn"]["q_proj"]
["w"]``, ``[K, N]`` so that ``y = x @ w``; one dict of ``pos{j}`` blocks per
period of the configuration's pattern, ``benchlib.parts.pattern``), in the
type they are served in.

Each part has a generator of its own, seeded from (seed, part, layer), the
layer ``p * len(pattern) + j``, so the reference can make any one block
again after the window without the rest.  A block is two large draws: one
uniform bf16 draw for all its matrices (its mixer's, then its ff's; each
scaled in place to ``U(-1/sqrt(K), 1/sqrt(K))``) and one f32 draw for its
vectors (``mixer_norm``, ``ff_norm`` where the ff is not null, the mixer's,
then an MoE router's).  An MoE block is laid out as the program's
``moe_init``: ``router.w`` f32 [d, E] (``U(-1/sqrt(d), 1/sqrt(d))``),
``gate_proj`` / ``up_proj`` [E, d, f], ``down_proj`` [E, f, d], and
``shared`` an MLP of width f where ``shared_expert`` is set.  A period of
one position draws what a single layer drew before periods were laid out.
Imports nothing of the program: the reference uses it too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchlib import parts

_PART = {"embed": 1, "layer": 2, "head": 3, "final": 4}
Matrix = Tuple[Tuple[str, ...], Tuple[int, ...]]


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


def ssm_sizes(cfg: Dict[str, Any]) -> Tuple[int, int, int, int]:
    """(d_inner, state, head size, heads) of a Mamba2 mixer."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, cfg["ssm_state"], cfg["ssm_headdim"], di // cfg["ssm_headdim"]


def _mlp(path: Tuple[str, ...], d: int, f: int) -> List[Matrix]:
    return [(path + ("gate_proj",), (d, f)), (path + ("up_proj",), (d, f)),
            (path + ("down_proj",), (f, d))]


def _matrices(cfg: Dict[str, Any], mixer: str,
              ff: Optional[str]) -> List[Matrix]:
    """(key path inside the block, shape) of every matrix of one block, in
    the order of its draw; a stacked expert matrix is [E, K, N]."""
    d = cfg["d_model"]
    if mixer == "attn":
        hq = cfg["num_heads"] * cfg["head_dim"]
        hk = cfg["num_kv_heads"] * cfg["head_dim"]
        mats = [(("attn", "q_proj"), (d, hq)), (("attn", "k_proj"), (d, hk)),
                (("attn", "v_proj"), (d, hk)), (("attn", "o_proj"), (hq, d))]
    else:
        di, ns, _, h = ssm_sizes(cfg)
        mats = [(("mamba", "in_proj"), (d, 2 * di + 2 * ns + h)),
                (("mamba", "out_proj"), (di, d))]
    f = cfg["d_ff"]
    if ff == "mlp":
        mats += _mlp(("mlp",), d, f)
    elif ff == "moe":
        e = cfg["num_experts"]
        mats += [(("moe", "gate_proj"), (e, d, f)),
                 (("moe", "up_proj"), (e, d, f)),
                 (("moe", "down_proj"), (e, f, d))]
        if cfg.get("shared_expert"):
            mats += _mlp(("moe", "shared"), d, f)
    return mats


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _gains(u: torch.Tensor) -> torch.Tensor:
    """Norm gains near 1 from uniforms: 1 + (u - 0.5) / 4."""
    return (1.0 + (u.to(torch.float32) - 0.5) * 0.25).to(torch.bfloat16)


def make_block(cfg: Dict[str, Any], seed: int, layer: int, mixer: str,
               ff: Optional[str], device: torch.device) -> Dict[str, Any]:
    """The block of stack layer ``layer``: ``mixer_norm`` and its mixer
    (``attn`` or ``mamba``), and ``ff_norm`` and its ff (``mlp`` or
    ``moe``) where ``ff`` is not None."""
    g = generator(seed, "layer", layer, device)
    mats = _matrices(cfg, mixer, ff)
    total = sum(math.prod(shape) for _, shape in mats)
    buf = torch.rand((total,), generator=g, device=device,
                     dtype=torch.bfloat16)
    blk: Dict[str, Any] = {}
    off = 0
    for path, shape in mats:
        size = math.prod(shape)
        w = buf[off:off + size].view(shape)
        s = 1.0 / math.sqrt(shape[-2])
        w.mul_(2.0 * s).sub_(s)
        _set(blk, path + ("w",), w)
        off += size
    d = cfg["d_model"]
    sizes = [d] + ([d] if ff is not None else [])
    if mixer == "attn":
        sizes += [cfg["head_dim"]] * 2
    else:
        di, ns, _, h = ssm_sizes(cfg)
        ch, width = di + 2 * ns, cfg["ssm_conv"]
        sizes += [di, width * ch, ch, h, h, h]
    if ff == "moe":
        sizes.append(d * cfg["num_experts"])
    vec = torch.rand((sum(sizes),), generator=g, device=device,
                     dtype=torch.float32)
    vecs = list(torch.split(vec, sizes))
    blk["mixer_norm"] = {"g": _gains(vecs.pop(0))}
    if ff is not None:
        blk["ff_norm"] = {"g": _gains(vecs.pop(0))}
    if mixer == "attn":
        qn, kn = vecs.pop(0), vecs.pop(0)
        if cfg.get("qk_norm"):
            blk["attn"]["q_norm"] = {"g": _gains(qn)}
            blk["attn"]["k_norm"] = {"g": _gains(kn)}
    else:
        norm, conv_w, conv_b, a_log, dt_u, d_skip = vecs[:6]
        del vecs[:6]
        lim = 1.0 / math.sqrt(width)
        dt = torch.exp(math.log(1e-3) + dt_u * math.log(100.0))
        blk["mamba"].update({
            "norm": {"g": _gains(norm)},
            "conv_w": ((conv_w * 2.0 - 1.0) * lim).view(width, ch)
            .to(torch.bfloat16),
            "conv_b": ((conv_b - 0.5) * 0.2).to(torch.bfloat16),
            "A_log": torch.log(1.0 + 15.0 * a_log),
            # dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "D": 0.5 + d_skip,
        })
    if ff == "moe":
        s = 1.0 / math.sqrt(d)
        blk["moe"]["router"] = {
            "w": (vecs.pop(0) * (2.0 * s) - s).view(d, cfg["num_experts"])}
    return blk


def make_period(cfg: Dict[str, Any], seed: int, period: int,
                device: torch.device) -> Dict[str, Any]:
    """Period ``period`` as the engine's ``{"pos0": ..., "pos{p-1}": ...}``."""
    pat = parts.pattern(cfg)
    return {f"pos{j}": make_block(cfg, seed, period * len(pat) + j, mixer,
                                  ff, device)
            for j, (mixer, ff) in enumerate(pat)}


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
        "layers": [make_period(cfg, seed, p, device)
                   for p in range(parts.periods(cfg))],
        "final_norm": {"g": make_final_norm(cfg, seed, device)},
    }
    if not cfg.get("tie_embeddings"):
        params["lm_head"] = {"w": make_head(cfg, seed, device)}
    return params
