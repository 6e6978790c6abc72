"""Self-speculative decoding: configuration and acceptance (port of
``repro.spec.speculate``).

The superplane store is MSB-first, so a low-precision draft model is a
plane prefix of the 8-bit weights already loaded: draft and verify are the
same engine at two prefix depths.  A round drafts k tokens at the draft
tier, verifies the (k+1)-token window ``[t0, d1..dk]`` in one batched
forward at the request's own tier, and keeps the accepted prefix:

* :func:`accept_counts` — leading accepted drafts by rejection sampling;
* :func:`correction_tokens` — the residual (or bonus) token at the stop
  position;
* :func:`emission_window` — the round's emission candidates.

Greedy requests go through the same code as the deterministic case: their
distributions are point masses (``sampling.sampling_probs``), so a draft is
accepted iff it equals the verify argmax and the correction is that argmax.
The scale math keeps the reference's reciprocal multiplies
(``p * (1/max(q, tiny))``, ``residual * (1/z)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.spec import sampling

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Per-request speculative-decoding configuration.

    ``draft_tier`` names the schedule tier that drafts (a plane prefix of
    the preloaded store, so drafting needs no extra weight bytes); ``k`` is
    the draft depth.  Slots with different ``k`` in one batch run the
    round at the largest ``k`` (deeper drafting is harmless)."""

    draft_tier: str
    k: int = 4

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")


def _recip(x: torch.Tensor) -> torch.Tensor:
    """IEEE ``1 / max(x, tiny)`` in f32."""
    d = torch.clamp_min(x, _TINY)
    return torch.div(torch.ones_like(d), d)


def _per_position_uniform(keys: torch.Tensor, counters: torch.Tensor,
                          tag: int) -> torch.Tensor:
    """One scalar uniform per (row, position): ``counters`` ``[B, k]``."""
    batch, k = counters.shape
    sub = sampling.fold_events(keys.repeat_interleave(k, dim=0),
                               counters.reshape(-1), tag)
    return sampling.uniform(sub, 1)[:, 0].reshape(batch, k)


def accept_counts(drafts: torch.Tensor, draft_probs: torch.Tensor,
                  verify_probs: torch.Tensor, keys: torch.Tensor,
                  draws: torch.Tensor) -> torch.Tensor:
    """Leading accepted drafts per row, by rejection sampling.

    drafts int32 ``[B, k]``; draft_probs f32 ``[B, k, V]``; verify_probs
    f32 ``[B, k+1, V]``; keys/draws the sampling state (read, not
    advanced).  Position j accepts with probability ``min(1, p_j(d_j) /
    q_j(d_j))``; the count is the length of the accepted prefix.
    Returns int32 ``[B]``."""
    k = drafts.shape[1]
    idx = drafts.to(torch.int64)[..., None]
    p_at_d = verify_probs[:, :k].gather(-1, idx)[..., 0]
    q_at_d = draft_probs.gather(-1, idx)[..., 0]
    ratio = p_at_d * _recip(q_at_d)
    counters = draws[:, None] + torch.arange(k, dtype=draws.dtype,
                                             device=draws.device)[None, :]
    u = _per_position_uniform(keys, counters, sampling.TAG_ACCEPT)
    accept = u < torch.clamp_max(ratio, 1.0)
    return torch.cumprod(accept.to(torch.int32), dim=1).sum(
        dim=1).to(torch.int32)


def correction_tokens(draft_probs: torch.Tensor, verify_probs: torch.Tensor,
                      m: torch.Tensor, keys: torch.Tensor,
                      draws: torch.Tensor) -> torch.Tensor:
    """The token emitted at each row's stop position ``m``: a draw from
    ``normalize(max(p_m - q_m, 0))`` at the first rejection, or from
    ``p_k`` when every draft was accepted (``q`` is zero-padded there).
    Greedy rows get the verify argmax at ``m`` exactly.  Returns int32
    ``[B]``; the caller advances ``draws``."""
    q_ext = torch.nn.functional.pad(draft_probs, (0, 0, 0, 1))
    stop = m.to(torch.int64)[:, None, None].expand(-1, 1,
                                                    verify_probs.shape[-1])
    p_stop = verify_probs.gather(1, stop)[:, 0]
    q_stop = q_ext.gather(1, stop)[:, 0]
    residual = torch.clamp_min(p_stop - q_stop, 0.0)
    z = residual.sum(dim=-1, keepdim=True)
    dist = residual * _recip(z)
    sub = sampling.fold_events(keys, draws, sampling.TAG_RESIDUAL)
    return sampling.gumbel_argmax(sub, torch.log(dist))


def emission_window(drafts: torch.Tensor, correction: torch.Tensor,
                    m: torch.Tensor) -> torch.Tensor:
    """The round's emission candidates, int32 ``[B, k+1]``: accepted drafts
    before ``m``, the correction at ``m``, zeros after (never emitted)."""
    k = drafts.shape[1]
    idx = torch.arange(k + 1, device=drafts.device)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    zero = torch.zeros_like(drafts_pad)
    return torch.where(idx < m[:, None], drafts_pad,
                       torch.where(idx == m[:, None], correction[:, None],
                                   zero)).to(torch.int32)


def accept_draw_events(k: int) -> int:
    """Draw events a sampled row spends per round beyond its k token draws:
    k accept draws + 1 residual/bonus draw."""
    return k + 1


__all__ = ["SpecConfig", "accept_counts", "accept_draw_events",
           "correction_tokens", "emission_window"]
