"""Tensor-parallel serving collectives over ``torch.distributed``: the
quantized wire, bit-identical to the unsharded engine (port of
``repro.distributed.tp_serve``).

Layout (the reference's, deliberately not Megatron column/row pairs):

* EVERY sharded projection is N-sharded on its LAST weight axis: q/k/v over
  heads, gate/up over d_ff, and o_proj/down_proj over d_model.  An N-shard
  never splits a K-reduction, so each rank's integer GEMM is an exact
  column slice of the unsharded accumulator.
* q/k/v/gate/up read the REPLICATED residual: their activation
  quantization sees the full row on every rank (kernels 1 and 2, as
  unsharded), with no collective at all.
* o_proj/down_proj read FEATURE-SHARDED inputs (local heads / local d_ff):
  local ``amax`` -> ``all_reduce(MAX)`` (max is exact) -> the shared scale
  equals the unsharded per-row scale -> the local codes are an exact
  K-slice of the unsharded codes -> all-gather the CODES (int8, or
  bit-packed at 4/2 bits: THE quantized wire) -> the full-K integer GEMM
  against the local N-shard (kernel 3, or kernel 4 through
  ``ops.fused_decode_linear(pre_quant=)``) -> all-gather the bf16 output
  columns back to the replicated residual.
* Scales never ride the wire: the all-reduce leaves each row's f32 scale
  replicated.

The quantization with the shared range is the plain one of
``kernels.ref`` (the kernels compute their own row maximum, which here
must come from every rank), with the same ``ref.quant_scale``, IEEE
divide and round-half-even, so its codes equal the kernels'.

Every gather goes through ``distributed.comm.all_gather_tiled``.
:data:`WIRE_BYTES` counts what this rank hands to the code and output
gathers, in the accounting of :func:`decode_wire_stats`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.comm import all_gather_tiled, all_reduce
from repro_torch.kernels import ops, ref

# Projections that read feature-sharded inputs and therefore need the
# quantized gather, matched on the layer name ``models.layers.linear``
# receives (``layers.pos1.attn.o_proj``).  ``.moe.`` and ``.mamba.``
# projections stay replicated and never match.
_GATHERED_SUFFIXES = (".attn.o_proj", ".mlp.down_proj")

# Bytes this rank sends to its n - 1 peers: the activation codes of the
# o/down gathers (``codes``) and the bf16 output columns (``outputs``).
WIRE_BYTES: Dict[str, int] = {"codes": 0, "outputs": 0}

# Shared-range quantizations run where the unsharded graph launches an
# act-quant kernel (cuda backend, CUDA tensors): a mesh engine's
# ``decode_dispatch_count`` adds them back.
STANDIN_QUANTS: Dict[str, int] = {"act_quant": 0}


def reset_wire_bytes() -> None:
    for key in WIRE_BYTES:
        WIRE_BYTES[key] = 0


@dataclasses.dataclass(frozen=True)
class TPConfig:
    """The tensor-parallel context threaded through ``Runtime.tp``: ``n``
    ranks, this process's ``rank`` among them, their process ``group``
    (None: the default group); ``kv_shards`` says whether k/v and the KV
    arena shard over KV heads (``num_kv_heads % n == 0``) or stay
    replicated (the MQA ``num_kv_heads == 1`` fallback, where every local
    query head reads the one shared KV head)."""

    n: int
    rank: int = 0
    kv_shards: bool = True
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def gathers(self, name: str) -> bool:
        """True for projections whose input is feature-sharded (o/down)."""
        return name.endswith(_GATHERED_SUFFIXES)


def _sent(key: str, t: torch.Tensor, n: int) -> None:
    WIRE_BYTES[key] += t.numel() * t.element_size() * (n - 1)


# ------------------------------------------------------ mesh-shared ranges
def _act_quant_pmax(x: torch.Tensor, bits: int,
                    group: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ref.act_quant_ref`` (signed) with the row max shared over the
    group: ``x`` holds each row's K-shard, and the max of the shard maxima
    is the row's max, so every rank gets the K-slice of the unsharded codes
    and the replicated f32 scale."""
    qmax = (1 << (bits - 1)) - 1
    xf = x.to(torch.float32)
    amax = all_reduce(xf.abs().amax(dim=-1, keepdim=True), group,
                      op=dist.ReduceOp.MAX)
    scale = ref.quant_scale(amax, qmax)
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def _act_quant_rows_pmax(x: torch.Tensor, row_groups: Any,
                         perm: Optional[torch.Tensor], group: Any
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops._quantize_activations_rows``' plain branch with the row max
    shared over the group: output row ``i`` quantizes the batch's row
    ``perm[i]`` at its group's ``a_bits`` (a per-row f32 qmax), so mixed
    tiers keep their bits across the mesh.  Returns PERMUTED codes and
    scales."""
    lead, k = x.shape[:-1], x.shape[-1]
    reps = 1
    for d in lead[1:]:
        reps *= d
    qmax = ops._qmax_column(tuple((rows * reps, g.a_bits)
                                  for rows, g in row_groups), x.device)
    x2 = x.reshape(-1, k)
    if perm is not None:
        if reps > 1:
            perm = (perm.reshape(-1, 1) * reps +
                    torch.arange(reps, device=perm.device)).reshape(-1)
        x2 = x2.index_select(0, perm)
    xf = x2.to(torch.float32)
    amax = all_reduce(xf.abs().amax(dim=-1, keepdim=True), group,
                      op=dist.ReduceOp.MAX)
    scale = ref.quant_scale(amax, qmax)
    q = torch.clamp(torch.round(xf / scale), min=-qmax - 1.0, max=qmax)
    return (q.to(torch.int8).reshape(*lead, k),
            scale.to(torch.float32).reshape(*lead, 1))


# -------------------------------------------------- bit-serial wire format
def wire_pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed ``bits``-wide int8 codes, ``8 // bits`` per byte:
    [..., K] -> uint8 [..., K * bits / 8], code ``j`` of a block at bit
    offset ``bits * j`` (two's complement at width ``bits``).  Packing is
    per K-block and in order, so it commutes with a tiled gather along K."""
    f = 8 // bits
    mask = (1 << bits) - 1
    u = q.view(torch.uint8) & mask
    blk = u.reshape(*u.shape[:-1], u.shape[-1] // f, f)
    return functools.reduce(torch.bitwise_or,
                            [blk[..., j] << (bits * j) for j in range(f)])


def wire_unpack(p: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`wire_pack`: uint8 [..., K*bits/8] -> int8 [..., K]
    with sign extension from width ``bits``."""
    f = 8 // bits
    mask = (1 << bits) - 1
    fields = torch.stack([(p >> (bits * j)) & mask for j in range(f)],
                         dim=-1)
    u = fields.reshape(*p.shape[:-1], p.shape[-1] * f).to(torch.int16)
    return torch.where(u >= (1 << (bits - 1)), u - (1 << bits),
                       u).to(torch.int8)


def wire_bytes_per_element(a_bits: int, signed: bool = True) -> float:
    """Wire bytes per gathered activation element: 8/6-bit tiers ride raw
    int8 (1 byte), 4/2-bit tiers pack 2/4 codes per byte.  The f32
    baseline is 4 bytes."""
    return a_bits / 8.0 if signed and a_bits in (2, 4) else 1.0


def gather_codes(q: torch.Tensor, bits: int, group: Any, *,
                 signed: bool = True) -> torch.Tensor:
    """All-gather activation codes tiled along K: the quantized wire.

    4/2-bit codes travel bit-packed (uint8, ``8 // bits`` per byte) when
    the local K divides the pack factor; 8/6-bit and unsigned codes travel
    as raw int8.  Returns the full-K int8 codes, equal on every rank to
    the unsharded quantizer's."""
    n = dist.get_world_size(group)
    f = 8 // bits if bits in (2, 4) else 1
    if signed and f > 1 and q.shape[-1] % f == 0:
        p = wire_pack(q, bits)
        _sent("codes", p, n)
        return wire_unpack(all_gather_tiled(p, -1, group), bits)
    _sent("codes", q, n)
    return all_gather_tiled(q, -1, group)


def _gather_output(y: torch.Tensor, group: Any) -> torch.Tensor:
    _sent("outputs", y, dist.get_world_size(group))
    return all_gather_tiled(y, -1, group)


def _count_standin(x: torch.Tensor, backend: str) -> None:
    if backend == "cuda" and x.is_cuda:
        STANDIN_QUANTS["act_quant"] += 1


# ----------------------------------------------------- gathered projections
def gathered_matmul(x: torch.Tensor, qw: ops.QuantizedWeight, prec: Any, *,
                    tp: TPConfig, out_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """One o/down projection under TP at one precision.

    x [..., K/n] feature-sharded; ``qw`` the local N-shard with FULL K
    rows.  Quantize with the shared range, gather the codes over the wire,
    run the plane-prefix GEMM + dequant of the unsharded graph
    (``ops.dequant_matmul``: kernel 3 on the ``cuda`` backend), and gather
    the output columns back to the replicated [..., N]."""
    if not prec.a_signed:
        raise ValueError("TP gathered projections need signed activations "
                         "(the shared range is symmetric)")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _count_standin(x, prec.backend)
    q, s = _act_quant_pmax(x, prec.a_bits, tp.group)
    q_all = gather_codes(q, prec.a_bits, tp.group)
    y_loc = ops.dequant_matmul(q_all, s, qw, prec, out_dtype)
    return _gather_output(y_loc, tp.group)


def gathered_grouped_matmul(x: torch.Tensor, qw: ops.QuantizedWeight,
                            row_groups: Any, perm: Optional[torch.Tensor], *,
                            tp: TPConfig) -> torch.Tensor:
    """Mixed-tier o/down projection under TP: the sharded twin of
    ``ops.fused_decode_linear``.  ONE shared-range quantization over the
    batch, one gather per GROUP at its ``a_bits`` (the bit-serial wire),
    then the unchanged group-switching GEMM + dequant epilogue (kernel 4)
    through ``pre_quant``, and the output gather.  Returns PERMUTED
    (group-sorted) rows like the unsharded path."""
    if not all(g.a_signed for _, g in row_groups):
        raise ValueError("TP mixed-tier decode needs signed activations")
    _count_standin(x, row_groups[0][1].backend)
    configs = tuple(dict.fromkeys(g.a_bits for _, g in row_groups))
    if len(configs) == 1:
        q, s = _act_quant_pmax(x, configs[0], tp.group)
        if perm is not None:
            q = q.index_select(0, perm)
            s = s.index_select(0, perm)
    else:
        q, s = _act_quant_rows_pmax(x, row_groups, perm, tp.group)
    gathered, off = [], 0
    for rows, g in row_groups:
        gathered.append(gather_codes(q[off:off + rows], g.a_bits, tp.group))
        off += rows
    y_loc = ops.fused_decode_linear(x, qw, row_groups, perm,
                                    pre_quant=(torch.cat(gathered), s),
                                    out_dtype=x.dtype)
    return _gather_output(y_loc, tp.group)


# --------------------------------------------------------------- accounting
def decode_wire_stats(cfg: Any, tp: TPConfig,
                      groups: Any) -> Dict[str, float]:
    """Analytic wire bytes for ONE decode step of the whole stack.

    ``groups``: the ``(rows, a_bits)`` pairs of the decode batch (a free
    slot's row rides its group).  Per period the quantized wire carries the
    o_proj gather (H*Dh elements per row) and the down_proj gather (d_ff
    per row) at each row's wire width; each of the ``n`` ranks sends its
    1/n shard to the n-1 others.  The bf16 output gathers and the 4-byte
    max scalars are reported apart; the f32 baseline prices the SAME
    gathered elements at 4 bytes."""
    n = tp.n
    pattern = cfg.period_pattern() * cfg.n_periods
    attn_layers = sum(1 for mixer, _ in pattern if mixer == "attn")
    mlp_layers = sum(1 for _, ff in pattern if ff == "mlp")
    per_row = attn_layers * cfg.num_heads * (cfg.head_dim or 0) \
        + mlp_layers * cfg.d_ff
    gathers = attn_layers + mlp_layers
    quant = 0.0
    base_f32 = 0.0
    elems = 0.0
    for rows, a_bits in groups:
        bpe = wire_bytes_per_element(a_bits)
        quant += rows * per_row * bpe * (n - 1) / n
        base_f32 += rows * per_row * 4.0 * (n - 1) / n
        elems += rows * per_row * (n - 1) / n
    rows_total = sum(r for r, _ in groups)
    out_bf16 = rows_total * cfg.d_model * 2.0 * gathers * (n - 1) / n
    pmax = rows_total * 4.0 * gathers * (n - 1) / n
    return {
        "quant_gather_bytes": quant,
        "f32_gather_bytes": base_f32,
        "out_gather_bytes": out_bf16,
        "pmax_bytes": pmax,
        "gathered_elements": elems,
        "bytes_per_element": quant / elems if elems else 0.0,
        "vs_f32": base_f32 / quant if quant else float("inf"),
    }
