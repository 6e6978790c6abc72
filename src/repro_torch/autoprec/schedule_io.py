"""Persist precision schedules: searched assignments as servable artifacts
(port of ``repro.autoprec.schedule_io``, the same file format).

A searched mixed-precision result is only useful if it survives the search
process — this module round-trips :class:`~repro_torch.core.policy
.PrecisionSchedule` (tiers, per-tier layer-glob rules, kv_tiers,
default_tier) through JSON, and emits search results as schedules:

* each selected :class:`~repro_torch.autoprec.search.SearchResult` becomes one
  named tier whose per-layer widths are exact-name rules over an 8/8
  default (exact layer names are valid globs, so the schedule contract —
  first matching rule wins — is unchanged);
* the stored 8-bit superplane serves every emitted tier by plane-prefix
  truncation, so a loaded schedule drives ``ServeEngine`` with zero weight
  re-preparations and token-identical to the in-memory original (asserted
  in tests/test_autoprec.py and tests/test_torch_autoprec.py).

Backend names: the port's ``cuda`` (the hand-written kernels) is the JAX
package's ``pallas``; a file names ``pallas`` for it
(``core.policy.JAX_BACKEND_NAME``) and reads it back as ``cuda``, so a
file written by either package loads in both and gives an equal schedule.

File format (``repro.precision_schedule.v1``)::

    {"format": "repro.precision_schedule.v1",
     "schedule": {"default_tier": ..., "tiers": {...}, "rules": {...},
                  "kv_tiers": {...} | null},
     "meta": {...}}        # free-form provenance (e.g. the Pareto table)

``repro_torch.launch.serve --schedule-file`` loads these;
``repro_torch.launch.autoprec`` writes them (and the JAX package's
counterparts do the same).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.autoprec.search import SearchResult
from repro_torch.core.policy import (JAX_BACKEND_NAME, LayerPrecision,
                                     PrecisionSchedule)

FORMAT = "repro.precision_schedule.v1"
# A file's backend name -> the port's.
PORT_BACKEND_NAME = {v: k for k, v in JAX_BACKEND_NAME.items()}


# ---------------------------------------------------------------- dict forms
def precision_to_dict(prec: LayerPrecision) -> Dict[str, Any]:
    """JSON-able form of one LayerPrecision (all five fields, explicit;
    the backend under its file name)."""
    return {"w_bits": int(prec.w_bits), "a_bits": int(prec.a_bits),
            "w_signed": bool(prec.w_signed), "a_signed": bool(prec.a_signed),
            "backend": JAX_BACKEND_NAME[prec.backend]}


def precision_from_dict(d: Mapping[str, Any]) -> LayerPrecision:
    try:
        return LayerPrecision(w_bits=int(d["w_bits"]),
                              a_bits=int(d["a_bits"]),
                              w_signed=bool(d["w_signed"]),
                              a_signed=bool(d["a_signed"]),
                              backend=PORT_BACKEND_NAME.get(
                                  str(d["backend"]), str(d["backend"])))
    except KeyError as e:
        raise ValueError(
            f"malformed LayerPrecision entry {dict(d)!r}: missing field "
            f"{e.args[0]!r}") from e


def schedule_to_dict(schedule: PrecisionSchedule) -> Dict[str, Any]:
    """JSON-able form of a PrecisionSchedule (exact round-trip:
    ``schedule_from_dict(schedule_to_dict(s)) == s``)."""
    return {
        "default_tier": schedule.default_tier,
        "tiers": {t: precision_to_dict(p)
                  for t, p in schedule.tiers.items()},
        "rules": {t: {glob: precision_to_dict(p)
                      for glob, p in by_layer.items()}
                  for t, by_layer in schedule.rules.items()},
        "kv_tiers": None if schedule.kv_tiers is None
        else {t: kb for t, kb in schedule.kv_tiers.items()},
    }


def schedule_from_dict(d: Mapping[str, Any]) -> PrecisionSchedule:
    """Rebuild (and fully re-validate: even bits, serving backends, shared
    signedness) a PrecisionSchedule from its dict form."""
    kv = d.get("kv_tiers")
    if "tiers" not in d:
        raise ValueError(f"malformed schedule dict (no 'tiers'): keys "
                         f"{sorted(d)}")
    return PrecisionSchedule(
        tiers={t: precision_from_dict(p) for t, p in d["tiers"].items()},
        rules={t: {glob: precision_from_dict(p)
                   for glob, p in by_layer.items()}
               for t, by_layer in d.get("rules", {}).items()},
        default_tier=d.get("default_tier"),
        kv_tiers=None if kv is None
        else {t: (None if kb is None else int(kb)) for t, kb in kv.items()})


# --------------------------------------------------------------------- files
def save_schedule(path: str, schedule: PrecisionSchedule,
                  meta: Optional[Mapping[str, Any]] = None) -> None:
    """Write a schedule (+ optional provenance meta) as JSON."""
    doc = {"format": FORMAT, "schedule": schedule_to_dict(schedule),
           "meta": dict(meta) if meta else {}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_schedule_with_meta(
        path: str) -> Tuple[PrecisionSchedule, Dict[str, Any]]:
    """Load a schedule file; returns (schedule, meta).  The schedule is
    re-validated by construction — a file naming odd widths or a dense
    backend fails here, not at serve time."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} file "
                         f"(format={doc.get('format')!r})")
    return schedule_from_dict(doc["schedule"]), dict(doc.get("meta", {}))


def load_schedule(path: str) -> PrecisionSchedule:
    return load_schedule_with_meta(path)[0]


# ------------------------------------------------------------ search results
def result_to_meta(result: SearchResult) -> Dict[str, Any]:
    """JSON-able provenance record of one search result."""
    return {"assignment": {n: int(b)
                           for n, b in sorted(result.assignment.items())},
            "a_bits": int(result.a_bits),
            "avg_bits": float(result.avg_bits),
            "cycles_per_token": float(result.cycles_per_token),
            "energy_per_token_j": float(result.energy_per_token_j),
            "pred_divergence": float(result.pred_divergence),
            "measured_divergence": result.measured_divergence,
            "strategy": result.strategy}


def schedule_from_results(results: Sequence[SearchResult], *,
                          tier_names: Optional[Sequence[str]] = None,
                          default: int = 0,
                          backend: str = "decomposed",
                          w_signed: bool = True,
                          include_base: bool = True,
                          kv_tiers: Optional[Mapping[str, Optional[int]]]
                          = None) -> PrecisionSchedule:
    """Emit searched results as one servable PrecisionSchedule.

    Each result becomes a tier (named ``tier_names[i]``, default
    ``auto-<avg_bits>b``) whose default precision is 8/``a_bits`` refined
    by one exact-name rule per layer the assignment lowers below 8 bits;
    ``results[default]`` becomes the schedule's default tier.
    ``include_base`` adds a plain uniform-8 ``base`` tier for A/B serving.
    Validation (even truncatable widths, serving backend, shared
    signedness) happens in the PrecisionSchedule constructor."""
    if not results:
        raise ValueError("no search results to emit")
    names = list(tier_names) if tier_names is not None else [
        f"auto-{r.avg_bits:.2f}b" for r in results]
    if len(names) != len(results):
        raise ValueError(f"{len(names)} tier names for "
                         f"{len(results)} results")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tier names {names}")
    tiers: Dict[str, LayerPrecision] = {}
    rules: Dict[str, Dict[str, LayerPrecision]] = {}
    for name, r in zip(names, results):
        base = LayerPrecision(w_bits=8, a_bits=r.a_bits, backend=backend,
                              w_signed=w_signed)
        tiers[name] = base
        rules[name] = {
            layer: dataclasses.replace(base, w_bits=int(b))
            for layer, b in r.assignment.items() if int(b) < 8}
    if include_base:
        if "base" in tiers:
            raise ValueError("tier name 'base' is reserved for the uniform "
                             "8-bit reference tier")
        tiers["base"] = LayerPrecision(w_bits=8, a_bits=results[0].a_bits,
                                       backend=backend, w_signed=w_signed)
    return PrecisionSchedule(
        tiers=tiers, rules=rules, default_tier=names[default],
        kv_tiers=None if kv_tiers is None else dict(kv_tiers))
