"""Manual tensor-parallel matmuls with QUANTIZED collectives over
``torch.distributed`` (port of ``repro.distributed.tp_matmul``).

The classic Megatron column/row-parallel pair, with the paper's
activation quantization as the *wire format*:

  column-parallel (W N-sharded):   y_n = gather_int8(x_sp) @ W[:, n]
  row-parallel (W K-sharded):      y_sp = reduce_scatter_bf16(x_n @ W[k_n, :])

Every rank is a process of its own (SPMD, ``launch.mesh``): where the
reference's ``shard_map`` hands each device its shard, each rank here
takes the shard of its place on the mesh's ``axis_name`` from the whole
arrays.  The all-gather moves int8 codes and one bf16 scale per row and
source shard, d + 2n bytes a token; the reduce-scatter moves bf16 partial
sums, 2d bytes a token (:func:`collective_bytes_per_token`).  The wire
quantizer is the compute quantizer, ``ops.quantize_activations``: kernel
1 (``act_quant``) on the card, its plain version on the CPU.  The bf16
matmuls stay ``torch.matmul``, as in the reference, outside any kernel.

The reduce-scatter adds the n partial sums in rank order, each addition
rounded to bf16 (``comm.reduce_scatter_ordered``), so the card and the
CPU sum alike; XLA's reduce-scatter sums in its own order, so the output
equals the reference's within a tolerance (the port's tests state it),
while the wire's codes and scales equal it bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.kernels import ops


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _quantize_rows(x: torch.Tensor,
                   bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire quantizer == compute quantizer: per-row codes of f32(x) and
    the row's scale cast to bf16 for the wire."""
    q, scale = ops.quantize_activations(x.to(torch.float32), a_bits=bits,
                                        signed=True)
    return q, scale.to(torch.bfloat16)


def _shard(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def column_parallel_quantized(x_sp: torch.Tensor, w_ncol: torch.Tensor, *,
                              group: object,
                              wire: Optional[Dict[str, torch.Tensor]] = None
                              ) -> torch.Tensor:
    """y_n = full(x) @ W_ncol with an int8 gather over ``group``.

    x_sp:   [..., K/n]  this rank's slice of the activations' last dim.
    w_ncol: [K, N/n]    this rank's column block of the weight.
    Returns [..., N/n].  ``wire`` (if given) receives the gathered
    ``codes`` [..., K] and ``scales`` [..., n]."""
    q, scale = _quantize_rows(x_sp)
    q_all = comm.all_gather_tiled(q, -1, group)             # [..., K]
    s_all = comm.all_gather_tiled(scale, -1, group)         # [..., n]
    if wire is not None:
        wire.update(codes=q_all, scales=s_all)
    # Per-source-shard dequantization: each scale over its K/n block.
    s_full = s_all.repeat_interleave(x_sp.shape[-1], dim=-1)
    x_full = q_all.to(torch.bfloat16) * s_full
    return torch.matmul(x_full, w_ncol.to(torch.bfloat16))


def row_parallel_scatter(x_n: torch.Tensor, w_krow: torch.Tensor, *,
                         group: object,
                         wire: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """y_sp = reduce_scatter(x_n @ W_krow) in bf16 over ``group``.

    x_n:    [..., N/n]  this rank's column block of the activations.
    w_krow: [N/n, K]    the matching row block of the weight.
    Returns [..., K/n], this rank's block of the sum.  ``wire`` (if given)
    receives the bf16 ``partial`` [..., K] handed to the reduce-scatter."""
    partial = torch.matmul(x_n.to(torch.bfloat16),
                           w_krow.to(torch.bfloat16))       # [..., K]
    if wire is not None:
        wire["partial"] = partial
    return comm.reduce_scatter_ordered(partial, -1, group)


def tp_mlp_block(mesh: object, x: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, *, axis_name: str = "model",
                 activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 wire: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """y = act(x @ w_up) @ w_down with quantized manual-TP collectives
    over the mesh's ``axis_name`` (every rank of that line calls it).

    x: [..., D] the same on every rank; w_up: [D, F]; w_down: [F, D].
    Each rank uses its shard: x's last dim, w_up's columns, w_down's
    rows.  Returns [..., D], the same on every rank.  ``wire`` (if given)
    receives what crossed the wire (``codes``, ``scales``, ``partial``)."""
    n = mesh.axis_size(axis_name)
    index = mesh.index(axis_name)
    group = mesh.group(axis_name)
    d, f = w_up.shape
    if d % n or f % n:
        raise ValueError(f"tp_mlp_block: D={d} and F={f} must divide "
                         f"across {n} ranks")
    h = column_parallel_quantized(_shard(x, -1, n, index),
                                  _shard(w_up, 1, n, index), group=group,
                                  wire=wire)
    h = activation(h.to(torch.float32)).to(torch.bfloat16)
    y_sp = row_parallel_scatter(h, _shard(w_down, 0, n, index), group=group,
                                wire=wire)
    return comm.all_gather_tiled(y_sp, -1, group)


def collective_bytes_per_token(d: int, f: int,
                               n_shards: int) -> Dict[str, float]:
    """Napkin math: wire bytes per token for one MLP block."""
    gather_int8 = d * 1 + (d // (d // n_shards)) * 2        # codes + scales
    gather_f32 = d * 4                                      # GSPMD on CPU
    gather_bf16 = d * 2                                     # native-TPU GSPMD
    scatter_bf16 = d * 2                                    # reduce-scatter
    allreduce_f32 = d * 4 * 2                               # AR moves ~2x
    return {
        "gather_int8": gather_int8,
        "vs_f32": gather_f32 / gather_int8,
        "vs_bf16": gather_bf16 / gather_int8,
        "reduce_scatter_bf16": scatter_bf16,
        "vs_allreduce_f32": allreduce_f32 / scatter_bf16,
    }
