"""Assigned input shapes and meta-tensor stand-ins for the dry-run (port of
``repro.launch.specs``).

Shapes (assignment): per-arch cells over
    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (prefill)
    decode_32k   seq 32768,  global_batch 128   (serve_step: 1 new token,
                                                 KV cache of seq_len)
    long_500k    seq 524288, global_batch 1     (serve_step; sub-quadratic
                                                 archs only)

The reference's stand-in is a ``jax.ShapeDtypeStruct``; the port's is a
tensor on the ``meta`` device, which has a shape, a dtype and strides and
allocates nothing, so the full configs are never allocated either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic token cost -> SSM/hybrid only
    (DESIGN.md §long_500k)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch has no sub-quadratic "
                       "path at seq 524288 (DESIGN.md §long_500k)")
    return True, ""


def meta(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that allocates nothing."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Training/prefill batch stand-ins (tokens or stub-frontend embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    out = {"labels": meta((b, s), torch.int32)}
    out.update(token_specs(cfg, b, s))
    return out


def token_specs(cfg: ArchConfig, batch: int, seq: int
                ) -> Dict[str, torch.Tensor]:
    if cfg.frontend == "none":
        return {"tokens": meta((batch, seq), torch.int32)}
    # VLM/audio stubs: precomputed patch/frame embeddings.
    return {"embeds": meta((batch, seq, cfg.d_model), torch.bfloat16)}


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for the cell's token
    count; decode counts one token per sequence."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens        # forward only
    tokens = shape.global_batch        # one new token per sequence
    return 2.0 * n * tokens
