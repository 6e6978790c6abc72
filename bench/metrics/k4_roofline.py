"""Kernel 4 (the group-switching dequant plane GEMM) against its roofline:
the least time of every launch the traced decode steps made, worked out
from their shapes (rows, widths, the planes the step's tier mix reads),
over the profiler's device time of ``plane_gemm_kernel<.., kGrouped=true>``."""
from benchlib import counts, trace


def read(ctx):
    if ctx.traced is None:
        return None
    busy = sum(o.end - o.start for o in ctx.ops()
               if (trace.core_kind(o.name) or (False, False))[1])
    if busy <= 0:
        return None
    packed = ctx.cfg.get("store") == "packed"
    least = 0.0
    for s in ctx.spans("decode_step"):
        groups = s.info["groups"]
        if len(groups) < 2:             # one tier: the plain plane GEMM
            continue
        least += counts.decode_step_k4(
            ctx.cfg, s.info["rows"], counts.group_pmax(groups,
                                                       ctx.cfg["tiers"]),
            len(groups), packed)
    return 100.0 * least / (busy / 1e6)
