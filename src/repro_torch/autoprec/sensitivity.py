"""Per-layer sensitivity profiling through the REAL quantization path (port
of ``repro.autoprec.sensitivity``).

Each probe runs the serving computation itself — the 8-bit MSB-first
superplane store with ONE layer's weights read at a truncated plane
prefix, exactly what a tier rule does at decode time — and records the
output divergence on calibration batches:

* ``kl``  — mean KL(base || perturbed) of the next-token distributions;
* ``mse`` — mean squared logit error.

Perturbing a layer to 8 bits IS the baseline (truncation to the stored
width is the identity), so those entries are exactly 0.0.

Two execution shapes, identical numbers:

* **sequential** — one full forward per probe tier (``Runtime.for_tier``:
  kernels 1 and 3 on the ``cuda`` backend);
* **batched one-pass** (default) — every probe of a *block* rides in ONE
  forward as a mixed-tier row-group batch (``Runtime.for_groups``): the
  calibration batch is tiled once per probe tier plus a baseline group,
  and every projection runs one group-switching GEMM over the groups
  (``ops.fused_decode_linear``: kernels 2 and 4, ``(block + 1) * batch *
  seq`` rows).  Every row is bit-identical to tier-homogeneous execution,
  which is what makes the two shapes agree.

The forwards run eagerly where the reference jits one per block.  MoE
configs fall back to sequential, as the reference's do: the per-expert
dispatch breaks the leading slot-batch axis outside the decode path.
The calibration tokens go to the device of the params' embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import numpy.typing as npt
import torch

from repro_torch.autoprec.cost import Assignment
from repro_torch.core.policy import LayerPrecision, PrecisionSchedule
from repro_torch.models.layers import Runtime
from repro_torch.serve import engine as engine_mod

BASE_TIER = "base"
MAX_BITS = 8
METRICS = ("kl", "mse")


@dataclasses.dataclass
class SensitivityProfile:
    """Measured per-(layer, width) output divergences.

    ``kl[layer][bits]`` / ``mse[layer][bits]`` hold the divergence of
    perturbing ONLY that layer to that width; ``table`` selects the
    profile's primary ``metric`` — the :mod:`repro_torch.autoprec.search`
    input."""

    a_bits: int
    choices: Tuple[int, ...]
    metric: str
    kl: Dict[str, Dict[int, float]]
    mse: Dict[str, Dict[int, float]]

    @property
    def layers(self) -> Tuple[str, ...]:
        return tuple(self.kl)

    @property
    def table(self) -> Dict[str, Dict[int, float]]:
        return self.kl if self.metric == "kl" else self.mse


def random_calibration(cfg: Any, *, batches: int = 2, batch: int = 2,
                       seq: int = 16, seed: int = 0
                       ) -> npt.NDArray[np.int32]:
    """Uniform-random token calibration set ``[batches, batch, seq]`` (the
    reference's draws: numpy ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batches, batch, seq))
    return toks.astype(np.int32)


def _probe_schedule(rules_by_tier: Mapping[str, Mapping[str, int]], *,
                    a_bits: int, backend: str,
                    w_signed: bool = True) -> PrecisionSchedule:
    """One schedule holding the 8-bit baseline tier plus one tier per
    probe, each probe refining its layers by per-layer width rules — the
    same (validated) object a searched result is later emitted as."""
    base = LayerPrecision(w_bits=MAX_BITS, a_bits=a_bits, backend=backend,
                          w_signed=w_signed)
    tiers = {BASE_TIER: base}
    rules: Dict[str, Dict[str, LayerPrecision]] = {}
    for tier, layer_bits in rules_by_tier.items():
        if tier == BASE_TIER:
            raise ValueError(f"probe tier name {BASE_TIER!r} is reserved")
        tiers[tier] = base
        rules[tier] = {
            name: dataclasses.replace(base, w_bits=int(b))
            for name, b in layer_bits.items() if int(b) < MAX_BITS}
    return PrecisionSchedule(tiers=tiers, rules=rules,
                             default_tier=BASE_TIER)


def _kl_mse(base_logits: torch.Tensor, pert_logits: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token-distribution KL(base || pert) and mean squared logit
    error, in f32."""
    bf = base_logits.to(torch.float32)
    pf = pert_logits.to(torch.float32)
    lb = torch.log_softmax(bf, dim=-1)
    lp = torch.log_softmax(pf, dim=-1)
    kl = torch.sum(torch.exp(lb) * (lb - lp), dim=-1).mean()
    mse = torch.mean((bf - pf) ** 2)
    return kl, mse


def measure_tiers(model: Any, params: Any,
                  rules_by_tier: Mapping[str, Mapping[str, int]], *,
                  calib: npt.NDArray[np.int32], a_bits: int = 8,
                  backend: str = "cuda", batched: Optional[bool] = None,
                  block: int = 8) -> Dict[str, Tuple[float, float]]:
    """Measure every probe tier's (kl, mse) divergence vs the 8-bit
    baseline, averaged over the calibration batches.

    ``rules_by_tier`` maps a probe name to the per-layer widths it
    perturbs; ``params`` may be float weights (prepared into the
    superplane store here, once) or an already-prepared superplane store
    (shared with a serving engine: zero extra preparations).
    ``batched=None`` takes the one-pass shape except for MoE configs."""
    calib = np.asarray(calib, np.int32)
    if calib.ndim != 3:
        raise ValueError(f"calib must be [batches, batch, seq], "
                         f"got shape {calib.shape}")
    if batched is None:
        batched = not bool(model.cfg.moe)
    schedule = _probe_schedule(rules_by_tier, a_bits=a_bits, backend=backend)
    rt = Runtime(policy=schedule.policy_for(BASE_TIER), moe_dropless=True,
                 schedule=schedule)
    if not engine_mod._params_prepared(params):
        params, _ = engine_mod.prepare_params(
            params, schedule.prepare_policy(), model, superplane=True)
    dev = params["embed"]["emb"].device
    toks = [torch.from_numpy(calib[b]).to(dev) for b in range(len(calib))]
    tiers = list(rules_by_tier)
    n_batches, batch, _ = calib.shape
    acc = {t: np.zeros((2,), np.float64) for t in tiers}

    with torch.no_grad():
        if batched:
            step = max(1, block)
            for start in range(0, len(tiers), step):
                blk = tuple(tiers[start:start + step])
                groups = ((BASE_TIER, batch),) + tuple((t, batch)
                                                       for t in blk)
                perm = torch.arange((len(blk) + 1) * batch, device=dev)
                rt_g = rt.for_groups(groups, perm)
                for b in range(n_batches):
                    logits, _ = model.forward(
                        params, rt_g, tokens=toks[b].repeat(len(blk) + 1, 1))
                    base = logits[:batch]
                    divs = torch.stack([torch.stack(_kl_mse(
                        base, logits[(j + 1) * batch:(j + 2) * batch]))
                        for j in range(len(blk))]).cpu().numpy()
                    for j, t in enumerate(blk):
                        acc[t] += divs[j].astype(np.float64)
        else:
            base_logits = [model.forward(params, rt.for_tier(BASE_TIER),
                                         tokens=toks[b])[0]
                           for b in range(n_batches)]
            for t in tiers:
                for b in range(n_batches):
                    pert, _ = model.forward(params, rt.for_tier(t),
                                            tokens=toks[b])
                    kl, mse = _kl_mse(base_logits[b], pert)
                    acc[t] += [float(kl), float(mse)]

    return {t: (float(acc[t][0] / n_batches), float(acc[t][1] / n_batches))
            for t in tiers}


def profile_sensitivity(model: Any, params: Any, *,
                        calib: npt.NDArray[np.int32],
                        choices: Sequence[int] = (2, 4, 6),
                        a_bits: int = 8, metric: str = "kl",
                        backend: str = "cuda",
                        layers: Optional[Sequence[str]] = None,
                        batched: Optional[bool] = None,
                        block: int = 8) -> SensitivityProfile:
    """Profile every quantizable layer's divergence at every width in
    ``choices`` (see the module doc for the measurement).

    ``layers`` restricts profiling to a subset (names from
    ``ArchConfig.quant_layer_macs``); widths >= 8 are recorded as exactly
    0.0 without running (truncation identity)."""
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    all_names = list(model.cfg.quant_layer_macs())
    if layers is None:
        names = all_names
    else:
        unknown = [n for n in layers if n not in all_names]
        if unknown:
            raise KeyError(f"unknown layers {unknown}; "
                           f"model has {all_names}")
        names = [n for n in all_names if n in set(layers)]
    ch = tuple(sorted(set(int(c) for c in choices)))
    probe_bits = [b for b in ch if b < MAX_BITS]
    rules_by_tier = {f"{n}@{b}": {n: b} for n in names for b in probe_bits}
    res = measure_tiers(model, params, rules_by_tier, calib=calib,
                        a_bits=a_bits, backend=backend, batched=batched,
                        block=block)
    kl: Dict[str, Dict[int, float]] = {n: {} for n in names}
    mse: Dict[str, Dict[int, float]] = {n: {} for n in names}
    for n in names:
        for b in ch:
            if b >= MAX_BITS:
                kl[n][b], mse[n][b] = 0.0, 0.0
            else:
                kl[n][b], mse[n][b] = res[f"{n}@{b}"]
    return SensitivityProfile(a_bits=a_bits, choices=ch, metric=metric,
                              kl=kl, mse=mse)


def measure_divergence(model: Any, params: Any,
                       assignments: Mapping[str, Assignment], *,
                       calib: npt.NDArray[np.int32], a_bits: int = 8,
                       metric: str = "kl", backend: str = "cuda",
                       batched: Optional[bool] = None,
                       block: int = 4) -> Dict[str, float]:
    """JOINT divergence of full per-layer assignments (all layers perturbed
    together) vs the 8-bit baseline — what the additive search surrogate is
    checked against before a point is emitted as a servable schedule."""
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    rules_by_tier = {name: {l: int(b) for l, b in a.items()}
                     for name, a in assignments.items()}
    res = measure_tiers(model, params, rules_by_tier, calib=calib,
                        a_bits=a_bits, backend=backend, batched=batched,
                        block=block)
    idx = METRICS.index(metric)
    return {name: res[name][idx] for name in assignments}
