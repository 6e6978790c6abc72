"""Quickstart on the PyTorch port: the paper's weight-combination scheme
end to end on one page (the twin of ``examples/quickstart.py``).

1. Decompose 2..8-bit weights into Table-I 2/3-bit planes.
2. Run the bit-exact bit-serial MAC (Eq. 1) and the PE-array simulator.
3. Run the plane-decomposed matmul and compare quality across precisions:
   on a CUDA card through the hand-written kernels (activation
   quantization, then one int8 tensor-core GEMM over the planes), on the
   CPU through the plain ``decomposed`` backend.

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import (PEArrayConfig, bitserial_mac, decompose,
                              decompose_weights, pe_array_matmul, peak_tops,
                              recompose_weights)
from repro_torch.core.policy import LayerPrecision
from repro_torch.device import integer_backend, resolve_device
from repro_torch.kernels import ops

WIDTHS = (2, 3, 4, 6, 8)


def run(device: Any = None, backend: Optional[str] = None) -> Dict[str, Any]:
    """The quickstart on ``device`` (default cuda).  Returns ``lines`` (what
    :func:`main` prints) and, per width of
    section 4, the int32 accumulator ``acc`` of the plane GEMM and the
    float output ``y``."""
    dev = resolve_device(device)
    backend = backend or integer_backend(dev)
    rng = np.random.default_rng(0)
    lines = []

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    lines.append("== 1. Table-I decomposition ==")
    w5 = rng.integers(-16, 16, size=(4,))
    planes = decompose_weights(t(w5), 5)        # 5-bit -> 3-2 (two planes)
    lines.append(f"5-bit weights {w5} -> planes (LSB-first):\n"
                 f"{planes.cpu().numpy()}")
    lines.append(f"recomposed: {recompose_weights(planes, 5).cpu().numpy()}")

    lines.append("\n== 2. Bit-serial MAC (Eq. 1) == ")
    a = rng.integers(-8, 8, size=(2, 16))       # 4-bit activations
    w = rng.integers(-16, 16, size=(16, 3))     # 5-bit weights
    mac = bitserial_mac(t(a), t(w), a_bits=4, w_bits=5)
    lines.append(f"bit-serial: {mac.cpu().numpy()}")
    lines.append(f"reference : {a @ w}")

    lines.append("\n== 3. 64x64 PE array simulator ==")
    a64 = rng.integers(-2, 2, size=(4, 64))
    w64 = rng.integers(-2, 2, size=(64, 64))
    out, stats = pe_array_matmul(t(a64), t(w64), w_bits=2, a_bits=2)
    assert np.array_equal(out.cpu().numpy(), a64 @ w64)
    lines.append(f"2/2-bit: util={stats.utilization:.2f} "
                 f"macs/cycle={stats.macs_per_cycle:.0f} "
                 f"peak={peak_tops(PEArrayConfig(), 2, 2):.2f} TOPS "
                 "(paper: 4.09)")

    where = "CUDA kernels" if backend == "cuda" else "plain PyTorch"
    lines.append(f"\n== 4. Plane-decomposed matmul ({where}), quality per "
                 "precision ==")
    x = t(rng.normal(size=(8, 256)).astype(np.float32))
    wf = t(rng.normal(size=(256, 64)).astype(np.float32))
    dense = x @ wf
    acc, ys = {}, {}
    for bits in WIDTHS:
        prec = LayerPrecision(w_bits=bits, a_bits=8, backend=backend)
        y = ops.matmul(x, wf, prec)
        # The integer product inside it: per-row 8-bit codes times the
        # LSB-first planes, exact int32.
        qw = ops.prepare_weight(wf, prec)
        x_q, _ = ops.quantize_activations(x, 8, plain=backend != "cuda")
        acc[bits] = (ops.bitserial_matmul_planes(x_q, qw) if backend == "cuda"
                     else decompose.decomposed_matmul(x_q, qw.planes, bits))
        ys[bits] = y
        rel = float((y - dense).abs().mean() / dense.abs().mean())
        n = decompose.num_planes(bits)
        lines.append(f"  w{bits}a8: {n} plane(s) in one GEMM, "
                     f"mean rel err {rel:.4f}")
    return {"lines": lines, "acc": acc, "y": ys}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
