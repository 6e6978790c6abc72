"""Build, load and launch the hand-written CUDA kernels.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, without ``--use_fast_math`` (the
kernels rely on IEEE division and round-half-even), and linked into one
shared library under ``build/kernels/`` at the repository root.  The
library has a plain C interface and is loaded with ``ctypes``: pointers and
the CUDA stream travel as ``c_void_p``, sizes as ``c_int``.  Every entry
point returns ``cudaGetLastError()`` after its launch, and :func:`launch`
raises when that is not ``cudaSuccess``.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures: "p" = pointer (c_void_p), "i" = int; the CUDA stream is
# always the last argument and is appended by launch().
SIGNATURES: Dict[str, str] = {
    "act_quant_gather": "piipippiiii",
    "act_quant_rows_gather": "piipipppii",
    "repro_noop": "",
    "bitserial_matmul_s8": "p" * 5 + "i" * 15,
    "packed_bitserial_matmul_u8": "p" * 5 + "i" * 13,
    "grouped_matmul_s8": "p" * 6 + "i" * 11,
    "grouped_matmul_u8": "p" * 6 + "i" * 13,
    "grouped_dequant_matmul_s8": "p" * 9 + "i" * 11,
    "grouped_dequant_matmul_u8": "p" * 9 + "i" * 13,
    "decode_attention": "p" * 8 + "i" * 22,
}

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else (chip_smoke.py reads them around the main path).
LAUNCHES: Dict[str, int] = {
    "act_quant": 0, "act_quant_rows": 0, "bitserial_matmul": 0,
    "grouped_dequant_matmul": 0, "packed_bitserial_matmul": 0,
    "grouped_matmul": 0, "decode_attention": 0}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_total() -> int:
    """Kernel launches so far, over every kernel."""
    return sum(LAUNCHES.values())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build() -> pathlib.Path:
    """Compile (if not already built from these exact sources) and return
    the path of the shared library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libreprokernels-{_digest()}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    objs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[f] for f in failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs), "-lcudart"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" +
                           link.stdout)
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path),
                      seconds=time.perf_counter() - t0, cached=False,
                      ptxas=logs)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, sig in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [ctypes.c_int]
        handle.repro_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; tensors
    pass as their data pointers.  Raises if the launch reports an error.
    The stream is read raw (no ``torch.cuda.Stream`` object is made), and
    the current device is switched only when it is not ``device``: the
    host runs this once a launch, hundreds of times a decode step."""
    handle = lib()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch.cuda.current_device() == index:
        err = getattr(handle, name)(*conv, stream)
    else:
        with torch.cuda.device(index):
            err = getattr(handle, name)(*conv, stream)
    if err != 0:
        msg = handle.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


def check_cuda(t: torch.Tensor, name: str) -> None:
    """Wrappers launch kernels only for CUDA tensors; any other device
    raises (CPU tensors never reach here: they take the plain version)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}, expected cuda")


def check_operands(name: str, *want) -> None:
    """Each ``(tensor, dtype)`` pair must be a contiguous tensor of that
    dtype on the first tensor's device (what the GEMM kernels take)."""
    dev = want[0][0].device
    for t, dt in want:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: expected contiguous {dt} on {dev}, got "
                             f"{t.dtype} on {t.device}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
