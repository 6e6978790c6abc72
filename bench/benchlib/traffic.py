"""The one traffic generator: a mix file of parameters -> the requests of a
run, deterministic in ``--seed``.

Every seed gets the same multiset of sizes and arrival gaps, in another
order: lengths, residual budgets and gaps are the quantiles of their
distributions at the midpoints of ``block`` equal strata, and the seed only
permutes them within each block of requests (and draws the prompt tokens).
So two seeds load the engine with the same work and differ in its order.

A mix file holds:

* ``loop``: ``closed`` (``clients`` concurrent clients, each sending its
  next request when the last one finished) or ``open`` (Poisson arrivals at
  ``rate_per_s``, starting ``warmup_s`` before the window opens).
* ``prompt`` / ``output``: ``{"median", "sigma", "min", "max"}`` of a
  lognormal, clipped.
* ``tiers``: tier name -> share.
* ``residual_start`` (closed loop): the first request of every client
  asks only a residual budget, uniform in 1..its drawn length, so the run
  starts in the middle of a running deployment.
* ``engine``: the serving engine's slot settings for this mix.
* ``check``: how many served requests the correctness check samples.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, List, Optional

import numpy as np

_PART = {"gap": 5, "tokens": 6, "order": 7, "sample": 8}


@dataclasses.dataclass
class Planned:
    """One request as the generator plans it (host data only)."""

    index: int                 # position in its stream
    prompt: np.ndarray         # int32 [P]
    max_new: int
    tier: str


def rng(seed: int, part: str, block: int = 0) -> np.random.Generator:
    """A generator for one part of the traffic, from the run's seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2**64 - 1), _PART[part], block]))


def strata(n: int) -> np.ndarray:
    """Midpoints of ``n`` equal strata of (0, 1)."""
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of a clipped lognormal, ascending."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf(u) for u in strata(n)])
    raw = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def tier_sequence(tiers: Dict[str, float], n: int) -> List[str]:
    """``n`` tier names in proportion to their shares (largest remainder),
    in the mix file's order."""
    names = list(tiers)
    total = float(sum(tiers.values()))
    exact = [tiers[t] / total * n for t in names]
    counts = [int(math.floor(e)) for e in exact]
    order = sorted(range(len(names)), key=lambda i: -(exact[i] - counts[i]))
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return [t for t, c in zip(names, counts) for _ in range(c)]


class Traffic:
    """The requests of one run of one mix, made block by block on demand
    (a closed loop asks for as many as the run completes)."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int) -> None:
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.block = int(mix.get("block", 64))
        self._blocks: Dict[int, List[Planned]] = {}

    def prompt_lengths(self) -> np.ndarray:
        """Every prompt length the run can send: each block permutes the
        same stratified set."""
        return lognormal_lengths(self.mix["prompt"], self.block)

    def _make_block(self, b: int, residual: bool) -> List[Planned]:
        n = self.block
        mix = self.mix
        r = rng(self.seed, "order", b)
        outputs = lognormal_lengths(mix["output"], n)
        if residual:
            # Residual budgets: the strata of U(0, 1] paired with the drawn
            # lengths in one fixed order, so every seed has the same set.
            frac = strata(n)[np.random.default_rng(0).permutation(n)]
            outputs = np.maximum(1, np.ceil(frac * outputs)).astype(np.int64)
        prompts = r.permutation(self.prompt_lengths())
        outputs = r.permutation(outputs)
        tiers = [str(t) for t in r.permutation(tier_sequence(mix["tiers"], n))]
        tok = rng(self.seed, "tokens", b)
        out = []
        for i in range(n):
            p = tok.integers(0, self.vocab, size=int(prompts[i]),
                             dtype=np.int64).astype(np.int32)
            out.append(Planned(index=b * n + i, prompt=p,
                               max_new=int(outputs[i]), tier=tiers[i]))
        return out

    def request(self, index: int) -> Planned:
        """Request ``index`` of the run's stream.  In a closed loop with
        ``residual_start`` the first block (one request per client) asks
        residual budgets."""
        b, i = divmod(index, self.block)
        if b not in self._blocks:
            residual = (b == 0 and self.mix["loop"] == "closed"
                        and bool(self.mix.get("residual_start")))
            self._blocks[b] = self._make_block(b, residual)
        return self._blocks[b][i]

    def arrivals(self, horizon_s: float) -> List[float]:
        """Open loop: due times (seconds after the load starts) up to
        ``horizon_s``; gaps are stratified exponential quantiles at
        ``rate_per_s``, permuted per block."""
        rate = float(self.mix["rate_per_s"])
        n = self.block
        dues: List[float] = []
        t, b = 0.0, 0
        while t < horizon_s:
            gaps = -np.log1p(-strata(n)) / rate
            for g in rng(self.seed, "gap", b).permutation(gaps):
                t += float(g)
                if t >= horizon_s:
                    break
                dues.append(t)
            b += 1
        return dues


def sample_indices(seed: int, groups: Dict[str, List[int]], per_group: int,
                   longest: Dict[str, Optional[int]]) -> List[int]:
    """The requests the correctness check reads: per group (tier), its
    longest request and ``per_group - 1`` more drawn from the seed."""
    chosen: List[int] = []
    for g, idxs in sorted(groups.items()):
        if not idxs:
            continue
        first = longest.get(g)
        pick = [first] if first is not None else []
        rest = [i for i in idxs if i != first]
        r = rng(seed, "sample", sum(map(ord, g)))
        k = max(0, min(len(rest), per_group - len(pick)))
        pick += [int(i) for i in r.choice(rest, size=k, replace=False)] \
            if k else []
        chosen += pick
    return chosen
