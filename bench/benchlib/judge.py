"""What decides ``correct``: the served tokens of a sample of requests,
drawn from the seed with each tier's longest stream in it, held against
the plain reference run over each prompt with its served tokens.

For each served token the number read is its gap: how far the
reference's logit for it lies below the reference's best logit at that
position.  Greedy serving that computes what the reference states picks
the reference's best token up to rounding, so its widest gap is small; a
lower precision, a stale cache or an altered token shows as a wide one.
The widest gap over every sampled token of every tier is compared with
its limit, beside two exact checks: every stream's tokens lie in the
vocabulary and no stream is longer than its request allows.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from benchlib import reference as R
from benchlib.serve import Rec
from benchlib.traffic import sample_indices


def pick(recs: Sequence[Rec], seed: int, per_tier: int) -> List[Rec]:
    """Per tier its longest stream and ``per_tier - 1`` more from the seed,
    among the requests that streamed tokens."""
    served = {r.planned.index: r for r in recs if r.tokens}
    groups: Dict[str, List[int]] = {}
    longest: Dict[str, Optional[int]] = {}
    for i, r in sorted(served.items()):
        t = r.planned.tier
        groups.setdefault(t, []).append(i)
        if longest.get(t) is None or len(r.tokens) > \
                len(served[longest[t]].tokens):
            longest[t] = i
    return [served[i] for i in sample_indices(seed, groups, per_tier,
                                              longest)]


def sequences(sample: Sequence[Rec], tiers: Dict[str, Sequence[int]]
              ) -> Tuple[List[torch.Tensor], List[int], List[Tuple[int, int]],
                         List[int], List[torch.Tensor]]:
    """(token sequences, prompt lengths, (w, a) bits, first logit
    position, served tokens) of each sampled request: the prompt and every
    served token but the last, read from the prompt's last position on."""
    seqs, plens, bits, first, served = [], [], [], [], []
    for r in sample:
        p = torch.as_tensor(r.planned.prompt, dtype=torch.int64)
        toks = torch.as_tensor(r.tokens, dtype=torch.int64)
        seqs.append(torch.cat([p, toks[:-1]]))
        plens.append(len(p))
        bits.append(tuple(int(b) for b in tiers[r.planned.tier]))
        first.append(len(p) - 1)
        served.append(toks)
    return seqs, plens, bits, first, served


def exact_checks(recs: Sequence[Rec], vocab_rows: int) -> Dict[str, float]:
    """Streams with a token outside the vocabulary rows, and streams longer
    than their request asked (both must be 0)."""
    bad_tok = sum(1 for r in recs if any(not 0 <= t < vocab_rows
                                         for t in r.tokens))
    too_long = sum(1 for r in recs if len(r.tokens) > r.planned.max_new)
    return {"bad_token_streams": float(bad_tok),
            "overlong_streams": float(too_long)}


def gap_readings(gaps: Sequence[torch.Tensor], sample: Sequence[Rec]
                 ) -> Dict[str, float]:
    """The widest gap over every sampled served token (``gap``, the number
    compared), and each tier's (``gap_<tier>``, read)."""
    out: Dict[str, float] = {"gap": 0.0}
    for g, r in zip(gaps, sample):
        key = f"gap_{r.planned.tier}"
        out[key] = max(out.get(key, 0.0), float(g.max()))
        out["gap"] = max(out["gap"], out[key])
    return out


def readings(cfg: Dict[str, Any], seed: int, recs: Sequence[Rec],
             sample: Sequence[Rec], device: torch.device,
             control: bool = False) -> Dict[str, float]:
    """Every number the check compares; with ``control`` also the
    control's under ``control_<name>``: the one-step-lower reference put in
    the program's place, its tokens the ones it puts first at each
    position of the same sequences, read in the full reference."""
    from benchlib.weights import padded_vocab
    seqs, plens, bits, first, served = sequences(sample, cfg["tiers"])
    ref = R.Reference(cfg, seed, device)
    rows = padded_vocab(cfg)
    with torch.no_grad():
        full = ref.logits(seqs, plens, bits, first)
        gaps = [R.gaps(f, s) for f, s in zip(full, served)]
        out = gap_readings(gaps, sample)
        if control:
            picks = R.control_tokens(ref, seqs, plens, bits, first)
            cg = [R.gaps(f, p) for f, p in zip(full, picks)]
            out.update({"control_" + k: v
                        for k, v in gap_readings(cg, sample).items()})
            out["control_bad_token_streams"] = float(sum(
                1 for p in picks if bool(((p < 0) | (p >= rows)).any())))
            out["control_overlong_streams"] = float(sum(
                1 for p, r in zip(picks, sample)
                if len(p) > r.planned.max_new))
    out.update(exact_checks(recs, rows))
    out["checked_tokens"] = float(sum(len(s) for s in served))
    return out


def control_values(values: Dict[str, float]) -> Dict[str, float]:
    """The control's numbers under the names the limits give."""
    return {k[len("control_"):]: v for k, v in values.items()
            if k.startswith("control_")}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, Any]]]:
    """Each compared number beside its limit; correct iff every number is
    present and at most its limit."""
    checks: Dict[str, Dict[str, Any]] = {}
    ok = True
    for name, lim in limits.items():
        v = values.get(name)
        if v is None:
            ok = False
            checks[name] = {"value": None, "limit": float(lim)}
            continue
        checks[name] = {"value": float(v), "limit": float(lim)}
        ok = ok and v <= lim
    return ok, checks


def print_checks(checks: Dict[str, Dict[str, Any]],
                 extra: Dict[str, float]) -> None:
    """The compared numbers with their limits, as the last lines on
    standard error (the numbers read but not compared before them)."""
    for name, v in sorted(extra.items()):
        if name not in checks:
            print(f"read {name} = {v!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
