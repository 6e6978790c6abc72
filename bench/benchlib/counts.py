"""Operations and bytes, counted from shapes: the least time of each GEMM
launch the traced window ran, and the model's operations per token.

A plane GEMM of ``M`` rows, ``K`` inputs and ``N`` outputs counts
``2*M*K*N`` operations at any plane count (the product it stands for), and
each input byte read once and each output byte written once: int8
activations, the weight planes the launch reads, the scales and tables it
takes, and its output.  The least time of a launch is the larger of its
operations at the int8 peak and its bytes at the HBM bandwidth.

The counts follow the configuration's pattern (``benchlib.parts``)
position by position.  An MoE counts the work the model needs, not the
launches the program happens to make: one projection of every held
expert is one unit whose operations are those of the routed rows (tokens
x k) and whose bytes read each expert's weights once a step; the shared
expert is an MLP at every token; the f32 router is no plane GEMM.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from benchlib import parts, peaks

Shape = Tuple[int, int, str]          # (K, N, name)


def _mixer(cfg: Dict[str, Any], mixer: str) -> List[Shape]:
    d = cfg["d_model"]
    if mixer == "mamba":
        di = cfg["ssm_expand"] * d
        ns, h = cfg["ssm_state"], di // cfg["ssm_headdim"]
        return [(d, 2 * di + 2 * ns + h, "in_proj"), (di, d, "out_proj")]
    hq = cfg["num_heads"] * cfg["head_dim"]
    hk = cfg["num_kv_heads"] * cfg["head_dim"]
    return [(d, hq, "q_proj"), (d, hk, "k_proj"), (d, hk, "v_proj"),
            (hq, d, "o_proj")]


def _mlp(cfg: Dict[str, Any], prefix: str = "") -> List[Shape]:
    d, ff = cfg["d_model"], cfg["d_ff"]
    return [(d, ff, prefix + "gate_proj"), (d, ff, prefix + "up_proj"),
            (ff, d, prefix + "down_proj")]


def projections(cfg: Dict[str, Any]) -> List[Shape]:
    """Every quantized projection of one period that runs at every token,
    position by position: (K, N, name).  The mixer's, then the MLP's or
    the MoE's shared expert; the routed experts are
    :func:`expert_projections`'."""
    out: List[Shape] = []
    for mixer, ff in parts.pattern(cfg):
        out += _mixer(cfg, mixer)
        if ff == "mlp":
            out += _mlp(cfg)
        elif ff == "moe" and cfg.get("shared_expert"):
            out += _mlp(cfg, "shared.")
    return out


def expert_projections(cfg: Dict[str, Any]) -> List[Shape]:
    """One expert's projections at every MoE position of one period."""
    return [s for _, ff in parts.pattern(cfg) if ff == "moe"
            for s in _mlp(cfg)]


def padded_vocab(cfg: Dict[str, Any]) -> int:
    return -(-int(cfg["vocab_size"]) // 256) * 256


def head(cfg: Dict[str, Any]) -> Shape:
    return (cfg["d_model"], padded_vocab(cfg), "lm_head")


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / peaks.PEAK_OPS_INT8, nbytes / peaks.HBM_BYTES_PER_S)


def grouped_launch(m: int, k: int, n: int, pmax: int, groups: int,
                   packed: bool) -> Tuple[float, float]:
    """(ops, bytes) of one group-switching dequant GEMM (kernel 4): x int8,
    the first ``pmax`` planes (or the packed store), the multiplier table
    int32 [M, Pmax], x scales f32 [M], row -> group int32 [M], weight
    scales f32 [G, N], bf16 output."""
    w = k * n if packed else pmax * k * n
    nbytes = m * k + w + 4 * m * pmax + 4 * m + 4 * m + 4 * groups * n \
        + 2 * m * n
    return 2.0 * m * k * n, float(nbytes)


def plane_launch(m: int, k: int, n: int, planes: int,
                 packed: bool) -> Tuple[float, float]:
    """(ops, bytes) of one plane GEMM (kernel 3, or 5 on the packed store):
    x int8, the plane prefix (or the packed store), int32 output."""
    w = k * n if packed else planes * k * n
    return 2.0 * m * k * n, float(m * k + w + 4 * m * n)


def all_experts(cfg: Dict[str, Any], launch: Tuple[float, float],
                weight_bytes: float) -> Tuple[float, float]:
    """(ops, bytes) of one projection of every held expert in one step,
    from ``launch``: that projection's (ops, bytes) at the step's routed
    rows (tokens x experts_per_token), which read one expert's weights;
    the other experts' ``weight_bytes`` each are added."""
    ops, nbytes = launch
    return ops, nbytes + (cfg["num_experts"] - 1) * weight_bytes


def decode_step_k4(cfg: Dict[str, Any], rows: int, pmax: int, groups: int,
                   packed: bool) -> float:
    """Least seconds of kernel 4 in one mixed-tier decode step."""
    shapes = projections(cfg) * parts.periods(cfg)
    if not cfg.get("tie_embeddings"):
        shapes.append(head(cfg))
    total = sum(least_seconds(*grouped_launch(rows, k, n, pmax, groups,
                                              packed))
                for k, n, _ in shapes)
    routed = rows * cfg.get("experts_per_token", 0)
    for k, n, _ in expert_projections(cfg) * parts.periods(cfg):
        w = k * n if packed else pmax * k * n
        total += least_seconds(*all_experts(
            cfg, grouped_launch(routed, k, n, pmax, groups, packed),
            w + 4 * groups * n))
    return total


def plane_gemms(cfg: Dict[str, Any], rows: int, planes: int, packed: bool,
                head_rows: int) -> float:
    """Least seconds of the plane GEMMs (kernel 3) of one forward at one
    tier: every layer at ``rows`` rows, the head at ``head_rows``."""
    periods = parts.periods(cfg)
    total = sum(least_seconds(*plane_launch(rows, k, n, planes, packed))
                for k, n, _ in projections(cfg) * periods)
    routed = rows * cfg.get("experts_per_token", 0)
    for k, n, _ in expert_projections(cfg) * periods:
        total += least_seconds(*all_experts(
            cfg, plane_launch(routed, k, n, planes, packed),
            k * n if packed else planes * k * n))
    if not cfg.get("tie_embeddings") and head_rows:
        k, n, _ = head(cfg)
        total += least_seconds(*plane_launch(head_rows, k, n, planes, packed))
    return total


def token_ops(cfg: Dict[str, Any], context: int) -> float:
    """The model's operations for one token at ``context`` positions
    (itself included): 2*K*N per projection and for the head (quantized,
    or tied to the embedding and in bf16); per MoE layer its router
    2*d*E, its k routed experts and its shared expert; per attention
    layer 2*2*H*Dh*context (scores and the weighted sum); per Mamba2 layer
    the SSM recurrence 4*H*N*P (the state's outer-product update and the
    readout) and its conv 2*W*C."""
    k, n, _ = head(cfg)
    periods = parts.periods(cfg)
    ops = sum(2.0 * k * n for k, n, _ in projections(cfg)) * periods \
        + 2.0 * k * n
    moe = sum(1 for _, ff in parts.pattern(cfg) if ff == "moe") * periods
    if moe:
        ops += sum(2.0 * k * n for k, n, _ in expert_projections(cfg)) \
            * periods * cfg["experts_per_token"] \
            + 2.0 * cfg["d_model"] * cfg["num_experts"] * moe
    mixers = [m for m, _ in parts.layers(cfg)]
    if "mamba" in mixers:
        di = cfg["ssm_expand"] * cfg["d_model"]
        ns, p = cfg["ssm_state"], cfg["ssm_headdim"]
        h = di // p
        ops += (4.0 * h * ns * p + 2.0 * cfg["ssm_conv"] * (di + 2 * ns)) \
            * mixers.count("mamba")
    if "attn" in mixers:
        ops += 4.0 * cfg["num_heads"] * cfg["head_dim"] * context \
            * mixers.count("attn")
    return ops


def prompt_ops(cfg: Dict[str, Any], length: int) -> float:
    """The model's operations for a prompt of ``length`` tokens: every
    position's projections and attention (causal), the head once."""
    k, n, _ = head(cfg)
    ops = (token_ops(cfg, 0) - 2.0 * k * n) * length + 2.0 * k * n
    attn = sum(1 for m, _ in parts.layers(cfg) if m == "attn")
    if attn:
        ops += 2.0 * cfg["num_heads"] * cfg["head_dim"] * length \
            * (length + 1) * attn
    return ops


def planes_of(w_bits: int) -> int:
    return w_bits // 2


def group_pmax(groups: Sequence[Tuple[str, int]],
               tiers: Dict[str, Sequence[int]]) -> int:
    return max(planes_of(int(tiers[t][0])) for t, _ in groups)
