"""Mixed-precision search: measured sensitivity vs modeled hardware cost
(port of ``repro.autoprec.search``).

Two strategies behind one interface, both consuming the same inputs — a
per-``(layer, width)`` divergence table
(:mod:`repro_torch.autoprec.sensitivity`, measured through the real
plane-prefix quantization path) and a
:class:`~repro_torch.autoprec.cost.CostModel` (modeled cycles/energy per
token) — and both returning a list of :class:`SearchResult` candidate
assignments:

* :func:`greedy_search` — the repaired greedy allocator: start every layer
  at the cheapest width and repeatedly grant the promotion with the best
  **marginal divergence reduction per marginal cycle**, recording the full
  trajectory (cheapest -> richest).  With a ``budget`` it reproduces the
  classic average-bit-constrained allocation
  (``core.policy.allocate_bits_by_sensitivity`` is a thin wrapper).
* :func:`relaxed_search` — a plinio-MixPrec-style differentiable
  relaxation: per-layer softmax distributions over the width choices,
  loss = expected divergence + lambda * expected modeled cycles, annealed
  to a discrete assignment by gradient descent with a falling temperature;
  one Pareto point per lambda.

:func:`pareto_front` prunes any candidate set to its non-dominated
(cycles, divergence) subset — the deliverable a
:class:`~repro_torch.core.policy.PrecisionSchedule` is then emitted from
(:mod:`repro_torch.autoprec.schedule_io`).

The divergence objective both strategies optimize is the **additive
surrogate** ``sum_l sens[l][bits_l]`` (each layer's measured one-at-a-time
divergence).  Candidate points worth serving should be re-measured jointly
(``sensitivity.measure_divergence``) — the CLI does, and stores the
measured value back on the result.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.autoprec.cost import Assignment, CostModel
from repro_torch.device import resolve_device

# layer -> width -> measured output divergence of perturbing ONLY that
# layer to that width (the baseline width, 8, is implicitly 0.0).
SensTable = Mapping[str, Mapping[int, float]]

# Widths reachable by runtime plane-prefix truncation (the serving
# contract a PrecisionSchedule validates).
EVEN_CHOICES = (2, 4, 6, 8)
MAX_BITS = 8


@dataclasses.dataclass
class SearchResult:
    """One searched operating point: a full per-layer width assignment plus
    its prices.  ``pred_divergence`` is the additive surrogate from the
    sensitivity table; ``measured_divergence`` is filled in when the point
    is re-measured jointly through the real quantization path."""

    assignment: Dict[str, int]
    a_bits: int
    avg_bits: float                 # MAC-weighted mean weight width
    cycles_per_token: float
    energy_per_token_j: float
    pred_divergence: float
    strategy: str
    measured_divergence: Optional[float] = None

    @property
    def divergence(self) -> float:
        """Measured divergence when available, surrogate otherwise."""
        return self.pred_divergence if self.measured_divergence is None \
            else self.measured_divergence


def sens_at(sens: SensTable, layer: str, bits: int) -> float:
    """Divergence of one layer at one width (0.0 at the 8-bit baseline or
    for layers the profile left unperturbed)."""
    if bits >= MAX_BITS:
        return 0.0
    table = sens.get(layer)
    if table is None:
        return 0.0
    return float(table[bits])


def predicted_divergence(sens: SensTable, assignment: Assignment) -> float:
    """Additive surrogate: sum of each layer's one-at-a-time divergence."""
    return float(sum(sens_at(sens, n, b) for n, b in assignment.items()))


def _validate_choices(choices: Sequence[int]) -> Tuple[int, ...]:
    ch = tuple(sorted(set(int(c) for c in choices)))
    if not ch:
        raise ValueError("need at least one width choice")
    bad = [c for c in ch if not 2 <= c <= MAX_BITS]
    if bad:
        raise ValueError(f"width choices must lie in 2..{MAX_BITS}, got {bad}")
    return ch


def make_result(assignment: Assignment, sens: SensTable, cost: CostModel,
                strategy: str) -> SearchResult:
    """Price one assignment into a :class:`SearchResult`."""
    a = {n: int(b) for n, b in assignment.items()}
    return SearchResult(
        assignment=a, a_bits=cost.a_bits,
        avg_bits=cost.average_bits(a),
        cycles_per_token=cost.cycles_per_token(a),
        energy_per_token_j=cost.energy_per_token_j(a),
        pred_divergence=predicted_divergence(sens, a),
        strategy=strategy)


# ------------------------------------------------------------------- greedy
def greedy_trajectory(layers: Sequence[str], sens: SensTable,
                      layer_cost: Mapping[str, Mapping[int, float]],
                      choices: Sequence[int], *,
                      budget: Optional[float] = None
                      ) -> List[Dict[str, int]]:
    """Greedy promotion core shared by :func:`greedy_search` and the
    classic budgeted allocator.

    Start every layer at ``min(choices)``; repeatedly promote the layer
    with the highest marginal gain rate — divergence removed per unit of
    ``layer_cost`` added — one choice step at a time, recording every
    intermediate assignment.  ``layer_cost[n][b]`` is the cost of serving
    layer ``n`` at width ``b`` (cycles for the hardware search, ``b *
    param_count`` for the average-bit wrapper).  A ``budget`` caps the
    TOTAL cost: a promotion that would exceed it permanently retires that
    layer (other layers keep promoting), reproducing the historical
    budgeted-allocator semantics.  Returns the trajectory
    cheapest -> richest (first entry: all layers at ``min(choices)``)."""
    ch = _validate_choices(choices)
    nxt = {b: ch[i + 1] for i, b in enumerate(ch[:-1])}
    bits: Dict[str, int] = {n: ch[0] for n in layers}
    total = sum(layer_cost[n][ch[0]] for n in layers)
    points = [dict(bits)]

    def rate(n: str, b_from: int, b_to: int) -> float:
        gain = sens_at(sens, n, b_from) - sens_at(sens, n, b_to)
        dc = layer_cost[n][b_to] - layer_cost[n][b_from]
        return gain / max(dc, 1e-30)

    # Heap entries are (negated rate, layer, from, to); an entry whose
    # `from` no longer matches the layer's current width is stale and
    # skipped (lazy invalidation keeps the loop O(L * |choices| * log L)).
    heap: List[Tuple[float, str, int, int]] = [
        (-rate(n, ch[0], nxt[ch[0]]), n, ch[0], nxt[ch[0]])
        for n in layers if ch[0] in nxt]
    heapq.heapify(heap)
    while heap:
        _, n, b_from, b_to = heapq.heappop(heap)
        if bits[n] != b_from:
            continue                      # stale entry
        dc = layer_cost[n][b_to] - layer_cost[n][b_from]
        if budget is not None and total + dc > budget:
            continue                      # retire this layer: over budget
        bits[n] = b_to
        total += dc
        points.append(dict(bits))
        if b_to in nxt:
            heapq.heappush(heap, (-rate(n, b_to, nxt[b_to]), n, b_to,
                                  nxt[b_to]))
    return points


def greedy_search(sens: SensTable, cost: CostModel, *,
                  choices: Sequence[int] = EVEN_CHOICES
                  ) -> List[SearchResult]:
    """Greedy marginal-divergence-per-marginal-cycle allocator.

    Every promotion step of :func:`greedy_trajectory` (cost =
    ``CostModel.layer_cycles``, no budget) becomes a candidate point, so
    the result sweeps the whole cycles axis from all-``min(choices)`` to
    all-``max(choices)``; run :func:`pareto_front` to prune."""
    ch = _validate_choices(choices)
    layer_cost = {n: {b: cost.layer_cycles(n, b) for b in ch}
                  for n in cost.layers}
    traj = greedy_trajectory(cost.layers, sens, layer_cost, ch)
    return [make_result(a, sens, cost, "greedy") for a in traj]


# ------------------------------------------------- differentiable relaxation
def default_lambdas(sens: SensTable, cost: CostModel, *,
                    choices: Sequence[int] = EVEN_CHOICES,
                    n: int = 9) -> List[float]:
    """Log-spaced lambda sweep centered where the two loss terms balance:
    lambda_mid = (total divergence span) / (total cycle span) over the
    per-layer choice ranges."""
    ch = _validate_choices(choices)
    s_span = sum(max(sens_at(sens, l, b) for b in ch)
                 - min(sens_at(sens, l, b) for b in ch)
                 for l in cost.layers)
    c_span = sum(max(cost.layer_cycles(l, b) for b in ch)
                 - min(cost.layer_cycles(l, b) for b in ch)
                 for l in cost.layers)
    mid = (s_span / c_span) if (s_span > 0 and c_span > 0) else 1.0
    return [float(mid * 10.0 ** e) for e in np.linspace(-2.0, 2.0, n)]


def relaxed_search(sens: SensTable, cost: CostModel, *,
                   choices: Sequence[int] = EVEN_CHOICES,
                   lambdas: Optional[Sequence[float]] = None,
                   steps: int = 200, lr: float = 0.25,
                   temp_start: float = 1.0, temp_end: float = 0.05,
                   device=None) -> List[SearchResult]:
    """plinio-MixPrec-style differentiable precision assignment.

    Each layer holds architecture logits ``alpha[l, k]`` over the width
    choices; the relaxed loss under softmax weights ``p = softmax(alpha /
    temp)`` is ``sum(p * sens) + lambda * sum(p * cycles)``.  Adam descent
    (the reference's step size, betas, eps and bias correction, all in
    f32) over a geometrically falling temperature anneals every layer's
    distribution toward a vertex; the final assignment is the per-layer
    argmax.  The surrogate divergence being additive, the converged vertex
    is the per-layer argmin of ``sens + lambda * cycles``.  One Pareto
    candidate per lambda (deduplicated).

    The reference differentiates with ``jax.grad`` inside a ``lax.scan``;
    here autograd takes the gradient and a Python loop the steps, on
    ``device`` (default cuda).  Softmax and exp may differ by an ulp
    between the two libraries; the argmax assignments are what agree."""
    dev = resolve_device(device)
    ch = _validate_choices(choices)
    layers = cost.layers
    sens_mat = torch.tensor([[sens_at(sens, l, b) for b in ch]
                             for l in layers], dtype=torch.float32,
                            device=dev)
    cyc_mat = torch.tensor([[cost.layer_cycles(l, b) for b in ch]
                            for l in layers], dtype=torch.float32,
                           device=dev)
    if lambdas is None:
        lambdas = default_lambdas(sens, cost, choices=ch)
    temps = torch.tensor(np.geomspace(temp_start, temp_end, max(2, steps)),
                         dtype=torch.float32, device=dev)
    b1, b2, eps = (torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in (0.9, 0.999, 1e-8))

    def anneal(lam: torch.Tensor) -> torch.Tensor:
        """Adam descent over the annealing temperature schedule."""
        target = sens_mat + lam * cyc_mat
        alpha = torch.zeros_like(sens_mat)
        m = torch.zeros_like(alpha)
        v = torch.zeros_like(alpha)
        t = torch.zeros((), dtype=torch.float32, device=dev)
        for temp in temps:
            a = alpha.detach().requires_grad_(True)
            p = torch.softmax(a / temp, dim=-1)
            (g,) = torch.autograd.grad(torch.sum(p * target), a)
            t = t + 1.0
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            mh = m / (1.0 - b1 ** t)
            vh = v / (1.0 - b2 ** t)
            alpha = alpha - lr * mh / (torch.sqrt(vh) + eps)
        return alpha

    results: List[SearchResult] = []
    seen: set[Tuple[Tuple[str, int], ...]] = set()
    for lam in lambdas:
        alpha = anneal(torch.tensor(lam, dtype=torch.float32, device=dev))
        idx = torch.argmax(alpha, dim=-1).cpu().numpy()
        assignment = {l: ch[int(k)] for l, k in zip(layers, idx)}
        key = tuple(sorted(assignment.items()))
        if key in seen:
            continue
        seen.add(key)
        results.append(make_result(assignment, sens, cost, "relaxed"))
    return results


# -------------------------------------------------------------------- front
def pareto_front(results: Sequence[SearchResult]) -> List[SearchResult]:
    """Non-dominated subset in the (cycles_per_token, divergence) plane,
    sorted cheapest first.  Uses each result's ``divergence`` property
    (measured when available, surrogate otherwise); exact ties keep the
    first (stable) candidate."""
    ordered = sorted(results, key=lambda r: (r.cycles_per_token,
                                             r.divergence))
    front: List[SearchResult] = []
    best = float("inf")
    for r in ordered:
        if r.divergence < best:
            front.append(r)
            best = r.divergence
    return front


def search(sens: SensTable, cost: CostModel, *,
           choices: Sequence[int] = EVEN_CHOICES,
           strategy: str = "both",
           lambdas: Optional[Sequence[float]] = None,
           device=None) -> List[SearchResult]:
    """Run the requested strategies and return the merged Pareto front
    (the relaxation on ``device``, default cuda)."""
    if strategy not in ("greedy", "relaxed", "both"):
        raise ValueError(f"unknown strategy {strategy!r}")
    candidates: List[SearchResult] = []
    if strategy in ("greedy", "both"):
        candidates.extend(greedy_search(sens, cost, choices=choices))
    if strategy in ("relaxed", "both"):
        candidates.extend(relaxed_search(sens, cost, choices=choices,
                                         lambdas=lambdas, device=device))
    return pareto_front(candidates)
