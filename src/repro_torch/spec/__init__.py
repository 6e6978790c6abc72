"""Sampling and self-speculative decoding from the plane prefix (port of
``repro.spec``).

* :mod:`repro_torch.spec.sampling` — seeded temperature / top-k / greedy
  token selection whose draws are the reference's threefry draws.
* :mod:`repro_torch.spec.speculate` — the acceptance rule of a
  speculative round (draft at a plane-prefix tier, verify the window in
  one batched forward).

Both are plain tensor modules; the engine integration lives in
``repro_torch.serve.engine``.
"""
from repro_torch.spec.sampling import (SamplingParams, sample_tokens,
                                       sampling_probs)
from repro_torch.spec.speculate import (SpecConfig, accept_counts,
                                        correction_tokens)

__all__ = [
    "SamplingParams",
    "SpecConfig",
    "accept_counts",
    "correction_tokens",
    "sample_tokens",
    "sampling_probs",
]
