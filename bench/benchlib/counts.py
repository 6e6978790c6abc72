"""Operations and bytes, counted from shapes: the least time of each GEMM
launch the traced window ran, and the model's operations per token.

A plane GEMM of ``M`` rows, ``K`` inputs and ``N`` outputs counts
``2*M*K*N`` operations at any plane count (the product it stands for), and
each input byte read once and each output byte written once: int8
activations, the weight planes the launch reads, the scales and tables it
takes, and its output.  The least time of a launch is the larger of its
operations at the int8 peak and its bytes at the HBM bandwidth.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from benchlib import peaks

Shape = Tuple[int, int, str]          # (K, N, name)


def projections(cfg: Dict[str, Any]) -> List[Shape]:
    """Every quantized projection of one decoder layer: (K, N, name)."""
    d = cfg["d_model"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * d
        ns, h = cfg["ssm_state"], di // cfg["ssm_headdim"]
        return [(d, 2 * di + 2 * ns + h, "in_proj"), (di, d, "out_proj")]
    hq = cfg["num_heads"] * cfg["head_dim"]
    hk = cfg["num_kv_heads"] * cfg["head_dim"]
    ff = cfg["d_ff"]
    return [(d, hq, "q_proj"), (d, hk, "k_proj"), (d, hk, "v_proj"),
            (hq, d, "o_proj"), (d, ff, "gate_proj"), (d, ff, "up_proj"),
            (ff, d, "down_proj")]


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


def decode_step_k4(cfg: Dict[str, Any], rows: int, pmax: int, groups: int,
                   packed: bool) -> float:
    """Least seconds of kernel 4 in one mixed-tier decode step."""
    shapes = projections(cfg) * cfg["num_layers"]
    if not cfg.get("tie_embeddings"):
        shapes.append(head(cfg))
    return sum(least_seconds(*grouped_launch(rows, k, n, pmax, groups,
                                             packed))
               for k, n, _ in shapes)


def plane_gemms(cfg: Dict[str, Any], rows: int, planes: int, packed: bool,
                head_rows: int) -> float:
    """Least seconds of the plane GEMMs (kernel 3) of one forward at one
    tier: every layer at ``rows`` rows, the head at ``head_rows``."""
    total = sum(least_seconds(*plane_launch(rows, k, n, planes, packed))
                for k, n, _ in projections(cfg) * cfg["num_layers"])
    if not cfg.get("tie_embeddings") and head_rows:
        k, n, _ = head(cfg)
        total += least_seconds(*plane_launch(head_rows, k, n, planes, packed))
    return total


def token_ops(cfg: Dict[str, Any], context: int) -> float:
    """The model's operations for one token at ``context`` positions
    (itself included): 2*K*N per projection and for the head (quantized,
    or tied to the embedding and in bf16); attention
    2*2*H*Dh*context per layer (scores and the weighted sum); the SSM
    recurrence 4*H*N*P per layer (the state's outer-product update and
    the readout) and its conv 2*W*C."""
    k, n, _ = head(cfg)
    ops = sum(2.0 * k * n for k, n, _ in projections(cfg)) \
        * cfg["num_layers"] + 2.0 * k * n
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * cfg["d_model"]
        ns, p = cfg["ssm_state"], cfg["ssm_headdim"]
        h = di // p
        ops += (4.0 * h * ns * p + 2.0 * cfg["ssm_conv"] * (di + 2 * ns)) \
            * cfg["num_layers"]
    else:
        ops += 4.0 * cfg["num_heads"] * cfg["head_dim"] * context \
            * cfg["num_layers"]
    return ops


def prompt_ops(cfg: Dict[str, Any], length: int) -> float:
    """The model's operations for a prompt of ``length`` tokens: every
    position's projections and attention (causal), the head once."""
    k, n, _ = head(cfg)
    ops = (token_ops(cfg, 0) - 2.0 * k * n) * length + 2.0 * k * n
    if cfg["family"] != "ssm":
        ops += 2.0 * cfg["num_heads"] * cfg["head_dim"] * length \
            * (length + 1) * cfg["num_layers"]
    return ops


def planes_of(w_bits: int) -> int:
    return w_bits // 2


def group_pmax(groups: Sequence[Tuple[str, int]],
               tiers: Dict[str, Sequence[int]]) -> int:
    return max(planes_of(int(tiers[t][0])) for t, _ in groups)
