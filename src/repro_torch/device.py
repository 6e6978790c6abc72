"""Device selection shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Asking for CUDA on a machine without
a GPU raises: nothing falls back to the CPU silently.  ``meta`` makes
trees of shapes only (the sharding rules' reckonings).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises; cuda,
    cpu and meta are accepted."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def integer_backend(device: torch.device) -> str:
    """The integer backend an entry point runs on ``device``: the
    hand-written kernels (``cuda``) on a card, their plain versions
    (``decomposed``) elsewhere."""
    return "cuda" if device.type == "cuda" else "decomposed"
