"""Where the harness finds a configuration's parts: its layer pattern, its
weights, its plain reference and its counts.

A configuration file's ``"pattern"`` lists one ``[mixer, ff]`` per
position of a period (mixer ``attn`` or ``mamba``; ff ``mlp``, ``moe`` or
``null``), as the program lays a period out (``pos0`` ... ``pos{p-1}``).
A dense file may leave it out (``[["attn", "mlp"]]``), and so may an SSM
file (``[["mamba", null]]``); every other family states it.

A file may also set ``"model": "<stem>"``: the harness then imports
``bench/models/<stem>.py``, which may define any of :data:`PARTS`
(``make_params``, a ``Reference`` subclass, the count functions).  What it
leaves out, the harness's own parts serve; a harness count function calls
the harness's other count functions, so a module that changes
``projections`` supplies whatever it wants built on it too.  Imports
nothing of the program.
"""
from __future__ import annotations

import importlib.util
import pathlib
import re
import types
from typing import Any, Dict, Optional, Tuple

MODELS = pathlib.Path(__file__).resolve().parents[1] / "models"
PARTS = ("make_params", "Reference", "projections", "token_ops",
         "prompt_ops", "decode_step_k4", "plane_gemms")
MIXERS = ("attn", "mamba")
FFS = ("mlp", "moe", None)
DEFAULT_PATTERN = {"dense": (("attn", "mlp"),), "ssm": (("mamba", None),)}
_STEM = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

Pattern = Tuple[Tuple[str, Optional[str]], ...]
# Loaded model modules by path: a run looks its parts up several times.
_LOADED: Dict[pathlib.Path, types.ModuleType] = {}


def pattern(cfg: Dict[str, Any]) -> Pattern:
    """The configuration's period: one (mixer, ff) per position."""
    if "pattern" not in cfg:
        if cfg["family"] not in DEFAULT_PATTERN:
            raise ValueError(f"configuration {cfg.get('name')!r} of family "
                             f"{cfg['family']!r} must state its 'pattern'")
        return DEFAULT_PATTERN[cfg["family"]]
    out = []
    for pos in cfg["pattern"]:
        mixer, ff = pos
        if mixer not in MIXERS or ff not in FFS:
            raise ValueError(f"'pattern' position {pos!r}: mixer one of "
                             f"{MIXERS}, ff one of {FFS}")
        out.append((mixer, ff))
    if not out:
        raise ValueError("'pattern' is empty")
    return tuple(out)


def periods(cfg: Dict[str, Any]) -> int:
    """How many periods of the pattern the stack holds."""
    n, p = cfg["num_layers"], len(pattern(cfg))
    if n % p:
        raise ValueError(f"num_layers {n} is not a whole number of periods "
                         f"of {p}")
    return n // p


def layers(cfg: Dict[str, Any]) -> Pattern:
    """Every layer of the stack: the pattern once per period."""
    return pattern(cfg) * periods(cfg)


def module(stem: str) -> types.ModuleType:
    """``bench/models/<stem>.py``, loaded once."""
    path = MODELS / f"{stem}.py"
    if not _STEM.match(stem) or not path.is_file():
        raise ValueError(f"configuration key 'model': no file {path}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "bench_model_" + re.sub(r"\W", "_", stem), path)
        mod = importlib.util.module_from_spec(spec)
        assert spec.loader is not None
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def of(cfg: Dict[str, Any]) -> types.SimpleNamespace:
    """The configuration's parts, each the model module's where it has one
    and the harness's otherwise."""
    from benchlib import counts, reference, weights
    own = module(cfg["model"]) if "model" in cfg else None
    harness = {"make_params": weights.make_params,
               "Reference": reference.Reference,
               **{n: getattr(counts, n) for n in PARTS[2:]}}
    return types.SimpleNamespace(**{
        n: getattr(own, n, f) if own is not None else f
        for n, f in harness.items()})
