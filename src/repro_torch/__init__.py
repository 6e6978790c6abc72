"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``models/``,
``configs/``, ``serve/``, ``launch/``) so each module's counterpart is easy
to find.  It imports torch and numpy only: never jax, and nothing of the
JAX package.  The four Pallas kernels on the serving path are hand-written
CUDA C++ for ``sm_90a`` under ``kernels/csrc/``; every kernel wrapper runs
its plain PyTorch version only for a tensor that lies on the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
