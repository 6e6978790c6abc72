"""2..8-bit symmetric integer quantization (port of ``repro.core.quant``).

Two's-complement signed or unsigned codes of 2..8 bits, per-tensor or
per-channel scales.  The weight scale is a true IEEE division,
``max(amax, eps) / qmax``: the reference runs it eagerly (``prepare_params``)
where XLA does not strength-reduce it, and the reciprocal-multiply form
differs from it by one ulp on some channels.  On CUDA, PyTorch turns a
division by a Python number into a multiply by its reciprocal, so the
divisor here is always a tensor on the operand's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.decompose import int_matmul


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization spec for one operand of one layer."""

    bits: int = 8
    signed: bool = True          # the paper's per-column signal S
    per_channel: bool = True     # per output-channel scales for weights
    channel_axis: int = -1       # axis holding output channels
    eps: float = 1e-8

    def __post_init__(self):
        if not (2 <= self.bits <= 8):
            raise ValueError(f"bits must be in 2..8, got {self.bits}")

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1


def compute_scale(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Symmetric scale: max|x| mapped to qmax.  Shape broadcasts against x."""
    if cfg.per_channel and x.ndim > 1:
        axis = cfg.channel_axis % x.ndim
        axes = tuple(a for a in range(x.ndim) if a != axis)
        amax = x.abs().amax(dim=axes, keepdim=True)
    else:
        amax = x.abs().amax()
    qmax = torch.full((), float(cfg.qmax), dtype=amax.dtype, device=amax.device)
    return torch.clamp_min(amax, cfg.eps) / qmax


def quantize(x: torch.Tensor, cfg: QuantConfig,
             scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> int.  Returns (q int8/uint8, scale f32), clipped to the
    q-range; rounding is half-to-even like ``jnp.round``."""
    scale = compute_scale(x, cfg) if scale is None else scale
    q = torch.clamp(torch.round(x / scale), cfg.qmin, cfg.qmax)
    dtype = torch.int8 if cfg.signed else torch.uint8
    return q.to(dtype), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int codes -> f32 values, ``f32(q) * scale``."""
    return q.to(torch.float32) * scale


class _SteRound(torch.autograd.Function):
    """``round`` (half to even) whose gradient is the identity: the
    reference's ``_ste_round`` custom_vjp."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.round(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a minimum of a maximum, so a value exactly at a bound
    passes half of its gradient, as in the reference (``torch.clamp``
    would pass all of it)."""
    def bound(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def fake_quant(x: torch.Tensor, cfg: QuantConfig,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient inside the clip
    range (the QAT building block); gradients equal ``jax.grad`` of the
    reference's, the half gradient at a clip bound included (an exact zero
    under unsigned quantization sits on ``qmin``)."""
    scale = compute_scale(x, cfg) if scale is None else scale
    return _SteRound.apply(_clip(x / scale, cfg.qmin, cfg.qmax)) * scale


MAX_BITS = 8   # the superplane store always quantizes weights at this width


def nested_scale(scale: torch.Tensor, from_bits: int,
                 to_bits: int) -> torch.Tensor:
    """Effective scale after truncating ``from_bits - to_bits`` LSBs.

    Exact in f32: the multiplier is a power of two."""
    return scale * float(1 << (from_bits - to_bits))


def truncate_qint(q: torch.Tensor, from_bits: int,
                  to_bits: int) -> torch.Tensor:
    """Drop the LSBs of an integer code: ``q >> (from_bits - to_bits)``.

    Arithmetic shift for signed codes, logical for unsigned (uint8 widens
    to int32 first), i.e. floor rounding of the nested code."""
    shift = from_bits - to_bits
    if shift < 0:
        raise ValueError(f"cannot truncate {from_bits}b up to {to_bits}b")
    return q.to(torch.int32) >> shift


def nested_quantize(x: torch.Tensor, cfg: QuantConfig,
                    scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> int at ``cfg.bits`` via the nested scheme: round-to-nearest
    once at MAX_BITS, then truncate LSBs.  Returns (q, effective scale)."""
    base = dataclasses.replace(cfg, bits=MAX_BITS)
    q8, s8 = quantize(x, base, scale=scale)
    q = truncate_qint(q8, MAX_BITS, cfg.bits)
    dtype = torch.int8 if cfg.signed else torch.uint8
    return q.to(dtype), nested_scale(s8, MAX_BITS, cfg.bits)


def quantize_unsigned_activations(x: torch.Tensor, bits: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-ReLU activations: unsigned per-tensor quantization (the S=0
    column signal).  Returns (uint8 codes, scale f32)."""
    cfg = QuantConfig(bits=bits, signed=False, per_channel=False)
    return quantize(x, cfg)


def int_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor,
                       x_scale: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """``f32(x_q @ w_q) * x_scale * w_scale``: the integer-domain matmul the
    accelerator performs, mapped back to float.  The product is exact
    (:func:`~repro_torch.core.decompose.int_matmul`)."""
    acc = int_matmul(x_q, w_q)
    return acc.to(torch.float32) * x_scale * w_scale
