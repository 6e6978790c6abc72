"""Serving request type (port of ``repro.serve.request``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import numpy.typing as npt

from repro_torch.spec.sampling import SamplingParams
from repro_torch.spec.speculate import SpecConfig


@dataclasses.dataclass
class Request:
    """One generation request (pure host data).

    ``tier`` names the precision tier on engines with a
    ``PrecisionSchedule`` (None = the schedule's default tier; must stay
    None on untiered engines).  ``deadline`` (scheduler-clock ticks after
    submission) is what ``SLOPolicy`` prices; FIFO admission ignores it.
    ``tenant`` names the request's tenant for ``SLOPolicy``'s
    ``tenant_weights`` (None weighs 1.0).  ``sampling`` selects seeded
    temperature / top-k sampling (None = greedy); ``spec`` turns on
    self-speculative decoding at a draft tier of the engine's schedule."""

    uid: int
    prompt: npt.NDArray[np.int32]  # [S] int32
    max_new_tokens: int = 16       # total tokens returned (>= 1)
    tier: Optional[str] = None
    deadline: Optional[float] = None
    tenant: Optional[str] = None
    sampling: Optional[SamplingParams] = None
    spec: Optional[SpecConfig] = None
