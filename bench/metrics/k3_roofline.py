"""Kernel 3 (the plane GEMM at one width) against its roofline: the least
time of every launch in the traced stretch (each prefill's projections
at its padded rows and its head at one row, and any one-tier decode
step), worked out from their shapes, over the profiler's device time of
``plane_gemm_kernel<.., kGrouped=false>``."""
from benchlib import counts, trace


def read(ctx):
    if ctx.traced is None:
        return None
    busy = sum(o.end - o.start for o in ctx.ops()
               if (trace.core_kind(o.name) or (True, True)) == (False, False))
    if busy <= 0:
        return None
    tiers = ctx.cfg["tiers"]
    least = 0.0
    for s in ctx.spans("prefill"):
        least += counts.plane_gemms(ctx.cfg, s.info["rows"],
                                    counts.planes_of(tiers[s.info["tier"]][0]),
                                    False, 1)
    for s in ctx.spans("decode_step"):
        groups = s.info["groups"]
        if len(groups) == 1:
            least += counts.plane_gemms(
                ctx.cfg, s.info["rows"],
                counts.planes_of(tiers[groups[0][0]][0]), False,
                s.info["rows"])
    return 100.0 * least / (busy / 1e6)
