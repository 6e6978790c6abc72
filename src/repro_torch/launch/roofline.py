"""Roofline analysis from dry-run artifacts (port of
``repro.launch.roofline``).

Terms per (arch x shape x mesh) cell, in seconds, from the per-device
figures of ``launch.dryrun``:

    compute    = flops              / peak_FLOP/s
    min_memory = min_bytes_accessed / HBM_bw
    collective = collective_bytes   / link_bw
    memory     = bytes_accessed     / HBM_bw

The bound (``step_time_bound_s``, ``dominant``, ``roofline_fraction``)
is the largest of the first three: a lower bound on the step.
``min_bytes_accessed`` is what a step must move (arguments read once,
outputs written once), independent of the op trace.  ``memory_s`` keeps
the reference's meaning, the counted bytes over HBM, but the port counts
eager, unfused ops, so it bounds fused kernels from above and moves with
the code: it is reported beside the bound, never as it.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM), the data sheet's
dense peaks at its 700 W power limit: 989 TFLOP/s bf16 (1979 TOP/s int8
for the decomposed integer path, whose served form is the int8 tensor-core
kernels) and 3.35 TB/s HBM3.  The link: one NDR InfiniBand 400 Gb/s NIC
per GPU, 50 GB/s (a DGX H100 node has eight ConnectX-7 400 Gb/s ports for
its eight GPUs): the production mesh's 16-wide axes span two nodes of
eight cards, so every collective over them crosses the NICs, and NVLink's
450 GB/s a direction inside a node is not the bound.  These are data-sheet
numbers, not measurements: a card set below 700 W runs slower.

The reference also reports ``collective_tpu_adj_s``, which halves the f32
collectives that XLA:CPU's bf16 -> f32 dot promotion creates; the port
does no such promotion (its collectives are reckoned from the leaves'
own dtypes), so that term is dropped.

Also reports MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) and the
usefulness ratio MODEL_FLOPS / counted flops, the dominant term, and a
one-line lever per cell.

    PYTHONPATH=src python -m repro_torch.launch.roofline --results build/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

PEAK_FLOPS_BF16 = 989e12        # per card, dense bf16 tensor cores
PEAK_OPS_INT8 = 1979e12         # decomposed integer path (int8 MMA)
HBM_BW = 3.35e12                # bytes/s per card
LINK_BW = 50e9                  # bytes/s, one NDR 400 Gb/s NIC per card
HARDWARE = "NVIDIA H100 80GB HBM3 (SXM), datasheet peaks, 700 W"


def roofline_terms(cell: Dict[str, Any], *, int8_peak: bool = False
                   ) -> Optional[Dict[str, Any]]:
    if cell.get("skipped"):
        return None
    chips = cell["n_devices"]
    flops = float(cell.get("flops") or 0.0)
    byts = float(cell.get("bytes_accessed") or 0.0)
    min_byts = float(cell["min_bytes_accessed"])
    coll = float(cell["collectives"]["total_bytes"])
    peak = PEAK_OPS_INT8 if int8_peak else PEAK_FLOPS_BF16
    # The dry-run's figures are per device: divide by per-card rates only.
    t_compute = flops / peak
    t_memory = byts / HBM_BW
    t_coll = coll / LINK_BW
    bound = {"compute": t_compute, "memory": min_byts / HBM_BW,
             "collective": t_coll}
    dominant = max(bound, key=bound.get)
    model_flops = float(cell.get("model_flops") or 0.0)
    total = flops * chips
    useful = model_flops / total if total else 0.0
    bound_time = bound[dominant]
    # Roofline fraction: useful model FLOPs per card-second at peak vs the
    # bound term (1.0 = the dominant resource is fully spent on model math).
    frac = (model_flops / chips / peak) / bound_time if bound_time else 0.0
    return {
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "min_memory_s": bound["memory"],
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_total": total,
        "useful_ratio": useful,
        "roofline_fraction": frac,
        "step_time_bound_s": bound_time,
    }


LEVERS = {
    "compute": "cut redundant flops (fewer quant passes, bf16 cast before "
               "matmul, the integer path on int8 tensor cores)",
    "memory": "cut bytes: pack weight planes (w_bits/8 B/weight), quantize "
              "KV cache, fuse quant into the GEMM epilogue",
    "collective": "reshard to remove all-gathers (2D->1D for small dims), "
                  "overlap with compute, compress grads",
}


def load_cells(result_dir: str) -> List[Dict[str, Any]]:
    cells = []
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def format_table(cells: List[Dict[str, Any]], *,
                 int8_peak_backends=("decomposed",)) -> str:
    rows = [f"Roofline on {HARDWARE}; per-device figures reckoned on meta "
            "tensors, not measured.", ""]
    header = ("| arch | shape | mesh | backend | compute s | min memory s | "
              "collective s | dominant | eager memory s | MODEL/HLO | "
              "roofline frac |")
    sep = "|" + "---|" * 11
    rows.append(header)
    rows.append(sep)
    for c in cells:
        if c.get("skipped"):
            rows.append(f"| {c['arch']} | {c['shape']} | {c.get('mesh','-')} | - "
                        f"| - | - | - | SKIP | - | - | {c['reason'][:60]} |")
            continue
        t = roofline_terms(
            c, int8_peak=c.get("backend") in int8_peak_backends)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['backend']} "
            f"| {t['compute_s']:.3e} | {t['min_memory_s']:.3e} "
            f"| {t['collective_s']:.3e} | **{t['dominant']}** "
            f"| {t['memory_s']:.3e} "
            f"| {t['useful_ratio']:.2f} | {t['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="build/dryrun")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    cells = load_cells(args.results)
    print(format_table(cells))
    if args.json_out:
        enriched = []
        for c in cells:
            t = roofline_terms(c) if not c.get("skipped") else None
            enriched.append({**c, "roofline": t})
        with open(args.json_out, "w") as f:
            json.dump(enriched, f, indent=1)


if __name__ == "__main__":
    main()
