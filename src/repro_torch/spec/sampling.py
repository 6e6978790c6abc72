"""Seeded temperature / top-k / greedy token selection (port of
``repro.spec.sampling``).

Every draw derives from the request's own key (``request_key(seed)``)
folded with a per-slot draw counter and a purpose tag, so a sampled stream
depends only on ``(seed, draw index, tag)``: never on slot assignment,
batch composition or chunk boundaries.  The draws are the reference's
draws: this module carries its own threefry2x32 and the bits -> f32
uniform conversion of ``jax.random`` (the partitionable bit layout, where
element ``i`` of a draw hashes the 64-bit counter ``i`` split into hi/lo
32-bit words).  ``torch.Generator`` is never used.

Keys are int64 tensors holding uint32 values (torch's uint32 lacks most
arithmetic): every add and rotate is masked back to 32 bits.

Greedy rows (``temperature == 0``) take ``torch.argmax`` of the raw logits
(ties to the first index, as ``jnp.argmax``).  Temperature is an f32
reciprocal multiply (``logits * (1/t)``), as in the reference.  The bits,
keys, uniforms and top-k threshold are exact; ``log`` and ``softmax`` are
the platform's own, so Gumbel noise and ``sampling_probs`` are close to
the reference's, not equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import numpy.typing as npt
import torch

# Purpose tags folded into each draw's subkey: the token draw, the
# speculative accept draw and the residual/bonus draw at the same counter
# value are independent streams.
TAG_TOKEN = 0
TAG_ACCEPT = 1
TAG_RESIDUAL = 2

# Guard for the temperature reciprocal on greedy rows (their sampled branch
# is discarded by the final ``where``).
_MIN_TEMP = 1e-6
_TINY = float(np.finfo(np.float32).tiny)
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature == 0`` (the default) is exact greedy.  ``top_k == 0``
    means no top-k restriction.  ``seed`` names the request's private
    stream: two requests with the same seed, prompt and tier sample the
    same tokens whatever else shares the batch."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def validate(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def request_key(seed: int) -> npt.NDArray[np.uint32]:
    """Host-side raw key of a request seed (uint32 ``[2]``): the
    reference's ``PRNGKey(seed)`` with 32-bit integers, ``[0, seed mod
    2^32]``."""
    return np.asarray([0, int(seed) & _MASK], dtype=np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; int64 tensors holding uint32 values,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys int64 ``[..., 2]``, data int
    ``[...]`` (taken mod 2^32) -> int64 ``[..., 2]``."""
    d = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def fold_events(keys: torch.Tensor, draws: torch.Tensor,
                tag: int) -> torch.Tensor:
    """Per-slot subkey of draw event ``draws[b]`` with purpose ``tag``:
    ``fold_in(fold_in(key, counter), tag)``.  keys ``[B, 2]``, draws
    ``[B]`` -> ``[B, 2]``."""
    return fold_in(fold_in(keys, draws), torch.full_like(draws, tag))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``n`` elements per key: keys
    ``[B, 2]`` -> int64 ``[B, n]``."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (f32) of ``n`` elements per key: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled into
    [minval, maxval) and floored at ``minval``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, f * span + lo)


def scale_logits(logits: torch.Tensor,
                 temperature: torch.Tensor) -> torch.Tensor:
    """Temperature as an f32 reciprocal multiply (``x * (1/t)``)."""
    t = torch.clamp_min(temperature.to(torch.float32), _MIN_TEMP)
    inv_t = torch.div(torch.ones_like(t), t)
    return logits.to(torch.float32) * inv_t[:, None]


def mask_top_k(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's ``top_k[b]`` largest values, the rest to ``-inf``;
    ``top_k[b] <= 0`` keeps the row.  Ties at the k-th value are all kept
    (a value threshold, not an index cutoff)."""
    vocab = scaled.shape[-1]
    k_eff = torch.where(top_k > 0, top_k.to(torch.int64),
                        torch.full_like(top_k, vocab, dtype=torch.int64))
    k_eff = torch.clamp(k_eff, 1, vocab)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thresh = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    return scaled.masked_fill(scaled < thresh, float("-inf"))


def gumbel_argmax(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row by the Gumbel-max trick: keys ``[B, 2]``
    (one subkey a row), f32 logits ``[B, V]`` (may hold ``-inf``) ->
    int32 ``[B]``."""
    u = uniform(keys, logits.shape[-1], minval=_TINY, maxval=1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  draws: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per row.  logits ``[B, V]``; keys int64 ``[B, 2]``;
    draws int32 ``[B]``; temperature f32 ``[B]``; top_k int32 ``[B]``;
    ``active`` bool ``[B]``: inactive rows neither sample nor advance
    their counter.  Returns ``(tokens int32 [B], new draws int32 [B])``;
    rows at temperature 0 return the raw-logits argmax exactly."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled_rows = temperature > 0.0
    if active is not None:
        sampled_rows = sampled_rows & active
    masked = mask_top_k(scale_logits(logits, temperature), top_k)
    drawn = gumbel_argmax(fold_events(keys, draws, TAG_TOKEN), masked)
    tokens = torch.where(sampled_rows, drawn, greedy)
    return tokens, draws + sampled_rows.to(draws.dtype)


def sampling_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """The post-temperature/top-k next-token distribution, f32 ``[B, V]``.
    Rows at temperature 0 are a point mass at the raw-logits argmax, so
    greedy requests go through the speculative acceptance rule as its
    deterministic case."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    masked = mask_top_k(scale_logits(logits, temperature), top_k)
    probs = torch.softmax(masked, dim=-1)
    point = torch.nn.functional.one_hot(greedy, vocab).to(torch.float32)
    return torch.where((temperature > 0.0)[:, None], probs, point)


__all__ = ["SamplingParams", "TAG_TOKEN", "TAG_ACCEPT", "TAG_RESIDUAL",
           "request_key", "threefry2x32", "fold_in", "fold_events",
           "random_bits", "uniform", "scale_logits", "mask_top_k",
           "gumbel_argmax", "sample_tokens", "sampling_probs"]
