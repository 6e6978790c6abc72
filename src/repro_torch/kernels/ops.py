"""Backend dispatch around the kernels (port of ``repro.kernels.ops``, the
subset the serving path runs).

A single ``matmul`` entry point routes through one of the backends of
``core.policy.BACKENDS``: ``dense``, ``fake_quant``, ``decomposed`` (plain
integer plane GEMMs) and ``cuda`` (the hand-written kernels, which take
their plain versions for CPU tensors).  Integer weights are prepared once
into a :class:`QuantizedWeight`: int8 planes, or the byte-packed store (one
uint8 per weight, ``packed``), plus a per-channel scale.

Mixed-tier decode batches (``matmul(row_groups=, perm=)``) run FUSED by
default: one per-row-range activation quantization + ONE group-switching
plane-prefix GEMM with the dequant epilogue (``fused_decode_linear``).
``fused=False`` keeps the per-group reference path, which the fused path
is bit-identical to.

The ``decomposed`` backend is plain end to end: its activation
quantization takes the plain versions in :mod:`ref` (the reference routes
every backend's to its Pallas kernel, with the same codes), so on the card
it launches no hand-written kernel and is the ``cuda`` backend's reference;
like the reference's, it unpacks a packed store into planes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import decompose, quant
from repro_torch.core.policy import INTEGER_BACKENDS, LayerPrecision
from repro_torch.kernels import act_quant as act_quant_kernel
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ref

# (rows, LayerPrecision) per contiguous tier group.
RowGroups = Tuple[Tuple[int, Any], ...]
# Shared activation-quant cache: one entry per distinct quant config of ONE
# input tensor (see quantize_activations_grouped).
ActQuants = Dict[Any, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class QuantizedWeight:
    """Decomposed, scaled integer weight — the preloaded array contents.

    Either ``planes`` int8 [P, K, N] or ``packed`` uint8 [K, N] (every 2-bit
    plane of a weight in one byte, plane c at bits 2c; even ``w_bits``
    only); ``scale`` f32 [1, N] per output channel.  ``msb_first=True``
    marks a superplane store: quantized once at 8 bits, planes MSB first,
    so any even effective width ``b`` is served by the first ``b/2`` planes
    with ``eff_scale(b)`` (the packed bytes are the same for both orders)."""

    planes: Optional[torch.Tensor]
    scale: torch.Tensor
    w_bits: int
    signed: bool = True
    packed: Optional[torch.Tensor] = None
    msb_first: bool = False
    # group_scales' tables, made once per tuple of widths (not a field of
    # the artifact: neither compared nor copied by dataclasses.replace).
    _group_scales: Dict[Tuple[int, ...], torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _experts: Dict[int, "QuantizedWeight"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def kn(self) -> Tuple[int, int]:
        if self.planes is not None:
            return self.planes.shape[1], self.planes.shape[2]
        assert self.packed is not None
        return self.packed.shape[0], self.packed.shape[1]

    def expert(self, i: int) -> "QuantizedWeight":
        """Expert ``i`` of an expert-stacked store (planes [E, P, K, N] or
        packed [E, K, N], scale [E, 1, N]) as a 2-D weight whose tensors
        are views of this one's; made once and kept, with its scale
        tables."""
        view = self._experts.get(i)
        if view is None:
            view = dataclasses.replace(
                self, planes=None if self.planes is None else self.planes[i],
                packed=None if self.packed is None else self.packed[i],
                scale=self.scale[i])
            self._experts[i] = view
        return view

    def get_planes(self) -> torch.Tensor:
        """Planes in this artifact's declared order (MSB-first iff
        ``msb_first``); unpacks the byte store."""
        if self.planes is not None:
            return self.planes
        assert self.packed is not None
        planes = unpack_planes(self.packed, self.w_bits, self.signed)
        return planes.flip(0) if self.msb_first else planes

    def get_planes_msb(self) -> torch.Tensor:
        """Planes in MSB-first order regardless of the declared order."""
        planes = self.get_planes()
        return planes if self.msb_first else planes.flip(0)

    def eff_scale(self, eff_bits: int) -> torch.Tensor:
        """Per-channel scale of the ``eff_bits``-truncated weight."""
        return quant.nested_scale(self.scale, self.w_bits, eff_bits)

    def group_scales(self, eff_list: Tuple[int, ...]) -> torch.Tensor:
        """f32 [G, N]: one effective per-channel scale row per group width
        (an exact power-of-two multiple of the stored scale), made at the
        first call for ``eff_list`` and kept, so a decode step makes none."""
        rows = self._group_scales.get(eff_list)
        if rows is None:
            n = self.kn[1]
            rows = torch.cat([
                (self.eff_scale(eff) if eff != self.w_bits else self.scale)
                .to(torch.float32).reshape(1, n) for eff in eff_list])
            self._group_scales[eff_list] = rows
        return rows


def prepare_weight(w: torch.Tensor, prec: LayerPrecision,
                   packed: bool = False) -> QuantizedWeight:
    """Quantize (per-channel symmetric) + Table-I decompose a float weight
    [K, N] at a fixed precision.  Even widths quantize nested (the code is
    the LSB-truncation of the 8-bit code), odd widths round to nearest.
    ``packed`` stores even widths as one byte per weight; odd widths keep
    their planes."""
    cfg = quant.QuantConfig(bits=prec.w_bits, signed=prec.w_signed,
                            per_channel=True, channel_axis=-1)
    if prec.w_bits % 2 == 0:
        q, scale = quant.nested_quantize(w, cfg)
    else:
        q, scale = quant.quantize(w, cfg)
    planes = decompose.decompose_weights(q, prec.w_bits, signed=prec.w_signed)
    if packed and prec.w_bits in bsm.PACKED_BITS:
        return QuantizedWeight(planes=None, scale=scale, w_bits=prec.w_bits,
                               signed=prec.w_signed,
                               packed=pack_planes(planes, prec.w_bits))
    return QuantizedWeight(planes=planes, scale=scale, w_bits=prec.w_bits,
                           signed=prec.w_signed)


def prepare_superplane(w: torch.Tensor, *, signed: bool = True,
                       packed: bool = False) -> QuantizedWeight:
    """Quantize + decompose ONCE at 8 bits into the MSB-first superplane
    store that serves every even runtime width.  ``packed`` packs the
    LSB-first view of the planes (the byte layout is indexed by plane
    position, so it serves both orders)."""
    cfg = quant.QuantConfig(bits=quant.MAX_BITS, signed=signed,
                            per_channel=True, channel_axis=-1)
    q8, scale = quant.quantize(w, cfg)
    planes_msb = decompose.decompose_superplanes(q8, signed=signed)
    if packed:
        return QuantizedWeight(
            planes=None, scale=scale, w_bits=quant.MAX_BITS, signed=signed,
            packed=pack_planes(planes_msb.flip(0), quant.MAX_BITS),
            msb_first=True)
    return QuantizedWeight(planes=planes_msb.contiguous(), scale=scale,
                           w_bits=quant.MAX_BITS, signed=signed,
                           msb_first=True)


def truncate_weight(qw: QuantizedWeight, eff_bits: int) -> QuantizedWeight:
    """The fixed-precision ``eff_bits`` artifact of a superplane store, in
    the store's layout: equal to ``prepare_weight`` at ``eff_bits`` without
    the float weights."""
    if not qw.msb_first:
        raise ValueError("truncate_weight needs a superplane (msb_first) store")
    planes = decompose.superplane_prefix(qw.get_planes(),
                                         eff_bits).flip(0).contiguous()
    scale = qw.eff_scale(eff_bits)
    if qw.packed is not None:
        return QuantizedWeight(planes=None, scale=scale, w_bits=eff_bits,
                               signed=qw.signed,
                               packed=pack_planes(planes, eff_bits))
    return QuantizedWeight(planes=planes, scale=scale, w_bits=eff_bits,
                           signed=qw.signed)


def pack_planes(planes: torch.Tensor, w_bits: int) -> torch.Tensor:
    """All 2-bit LSB-first planes of an even-width weight in one uint8 per
    weight, plane c at bits [2c, 2c+1]: K*N weight bytes instead of P*K*N."""
    if w_bits not in bsm.PACKED_BITS:
        raise ValueError(f"only even widths pack, got {w_bits}")
    acc = torch.zeros(planes.shape[1:], dtype=torch.uint8,
                      device=planes.device)
    for c in range(planes.shape[0]):
        field = (planes[c].to(torch.int32) & 0x3).to(torch.uint8)
        acc |= field << (2 * c)
    return acc


def unpack_planes(packed: torch.Tensor, w_bits: int,
                  signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_planes`: int8 [P, K, N] LSB-first, the MSB
    plane signed iff ``signed``.  P counts planes as the reference does,
    ``num_planes(w_bits)`` at its default ``signed=True``."""
    p = decompose.num_planes(w_bits)
    planes = []
    for c in range(p):
        field = ((packed >> (2 * c)) & 0x3).to(torch.int32)
        if signed and c == p - 1:
            field = torch.where(field >= 2, field - 4, field)
        planes.append(field.to(torch.int8))
    return torch.stack(planes)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] as the act-quant kernels' [R, K] rows: a view wherever
    the last axis is contiguous (the kernels take any row stride)."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def quantize_activations(x: torch.Tensor, a_bits: int, *,
                         signed: bool = True, plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row activation quantization.  x f32/bf16 [..., K] -> (codes,
    scale [..., 1]), through the ``act_quant`` kernel wrapper, which reads
    x in its own dtype (``plain``: through its plain version)."""
    lead, k = x.shape[:-1], x.shape[-1]
    fn = ref.act_quant_ref if plain else act_quant_kernel.act_quant
    q, s = fn(_rows(x), bits=a_bits, signed=signed)
    return q.reshape(*lead, k), s.reshape(*lead, 1)


def _quantize_shared(x: torch.Tensor, a_bits: int, a_signed: bool,
                     plain: bool, act_quants: Optional[ActQuants]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_activations`` of the UN-permuted ``x``, made once per
    config for all projections sharing ``act_quants``."""
    key = ("uniform", a_bits, a_signed, plain)
    if act_quants is not None and key in act_quants:
        return act_quants[key]
    qs = quantize_activations(x, a_bits, signed=a_signed, plain=plain)
    if act_quants is not None:
        act_quants[key] = qs
    return qs


def _group_plane_counts(qw: QuantizedWeight,
                        eff_list: Sequence[int]) -> Tuple[int, ...]:
    """MSB-first plane-prefix depth per group; validates the store serves
    every requested effective width."""
    counts = []
    for eff in eff_list:
        if eff != qw.w_bits and not qw.msb_first:
            raise ValueError(
                f"effective {eff}b from a fixed {qw.w_bits}b weight needs a "
                "superplane (msb_first) store")
        counts.append(decompose.num_prefix_planes(eff) if qw.msb_first
                      else decompose.num_planes(qw.w_bits, qw.signed))
    return tuple(counts)


def _store_args(qw: QuantizedWeight) -> Dict[str, Any]:
    """Layout arguments of the grouped kernels for ``qw``'s store."""
    return dict(packed=qw.packed is not None,
                store_planes=decompose.num_planes(qw.w_bits, qw.signed),
                signed=qw.signed)


def _msb_prefix(qw: QuantizedWeight, pmax: int) -> torch.Tensor:
    """What the grouped kernels read: the packed store itself, or the first
    ``pmax`` MSB-first planes."""
    if qw.packed is not None:
        return qw.packed
    return qw.get_planes_msb()[:pmax].contiguous()


def bitserial_matmul_planes(x_int8: torch.Tensor, qw: QuantizedWeight, *,
                            eff_bits: Optional[int] = None,
                            row_groups: Optional[Tuple[Tuple[int, int], ...]]
                            = None) -> torch.Tensor:
    """Plane GEMM int8 [..., K] x the store -> int32 [..., N] (the port's
    ``bitserial_matmul_pallas``).  ``eff_bits`` below the stored width
    runtime-truncates a superplane store to its plane prefix, so the work
    scales with the EFFECTIVE width: int8 planes go to ``bitserial_matmul``,
    a packed store to ``packed_bitserial_matmul``.

    ``row_groups`` (``(rows, eff_bits)`` per contiguous group of x's
    leading axis) runs ONE ``grouped_matmul`` over every group instead, on
    either layout; extra leading dims scale each group's rows."""
    lead = x_int8.shape[:-1]
    k, n = qw.kn
    x2 = x_int8.reshape(-1, k).contiguous()
    if row_groups is not None:
        if sum(r for r, _ in row_groups) != x_int8.shape[0]:
            raise ValueError(f"row_groups {row_groups} do not cover leading "
                             f"axis {x_int8.shape[0]}")
        reps = x2.shape[0] // max(1, x_int8.shape[0])
        counts = _group_plane_counts(qw, tuple(e for _, e in row_groups))
        mult, _ = _group_tables(tuple((rows * reps, p) for (rows, _), p
                                      in zip(row_groups, counts)), x2.device)
        out = gmm.grouped_matmul(x2, _msb_prefix(qw, int(mult.shape[1])),
                                 mult, **_store_args(qw))
        return out.reshape(*lead, n)
    eff = qw.w_bits if eff_bits is None else eff_bits
    if eff != qw.w_bits and not qw.msb_first:
        raise ValueError(
            f"effective {eff}b from a fixed {qw.w_bits}b weight needs a "
            "superplane (msb_first) store")
    if qw.packed is not None:
        out = bsm.packed_bitserial_matmul(x2, qw.packed, w_bits=qw.w_bits,
                                          eff_bits=eff, signed=qw.signed)
        return out.reshape(*lead, n)
    planes = qw.get_planes()
    if qw.msb_first:
        planes = decompose.superplane_prefix(planes, eff)
        shifts = decompose.prefix_shifts(decompose.planes_count(planes))
    else:
        shifts = tuple(2 * c for c in range(planes.shape[0]))
    out = bsm.bitserial_matmul(x2, planes, shifts)
    return out.reshape(*lead, n)


# Per-layout constants (the reference bakes them into its trace): built once
# per (layout, device) so the decode loop makes no host-to-device copies.
@functools.lru_cache(maxsize=1024)
def _qmax_column(rows_bits: Tuple[Tuple[int, int], ...],
                 device: torch.device) -> torch.Tensor:
    """f32 [sum(rows), 1] of ``2^(b-1) - 1`` per row, in group order."""
    return torch.from_numpy(np.concatenate([
        np.full((rows, 1), float((1 << (bits - 1)) - 1), np.float32)
        for rows, bits in rows_bits])).to(device)


@functools.lru_cache(maxsize=1024)
def _group_tables(plane_groups: Tuple[Tuple[int, int], ...],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 multiplier table [M, Pmax], int32 row -> group index [M])."""
    mult = torch.from_numpy(decompose.prefix_multipliers(plane_groups))
    row_group = torch.from_numpy(np.repeat(
        np.arange(len(plane_groups), dtype=np.int32),
        [rows for rows, _ in plane_groups]))
    return mult.to(device), row_group.to(device)


def _quantize_activations_rows(x: torch.Tensor, row_groups: RowGroups,
                               perm: Optional[torch.Tensor], *,
                               plain: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-width per-row activation quantization (signed) in one launch:
    output row ``i`` quantizes the batch's row ``perm[i]`` (group order)
    at its own ``a_bits``, carried by a per-row f32 qmax; the kernel
    gathers the rows and reads x in its own dtype itself.  Each row's codes
    and scale depend on that row alone, so they equal quantizing the
    un-permuted batch and gathering the results."""
    lead, k = x.shape[:-1], x.shape[-1]
    reps = 1                       # flat rows per leading row
    for d in lead[1:]:
        reps *= d
    qmax = _qmax_column(tuple((rows * reps, g.a_bits) for rows, g in
                              row_groups), x.device)
    if perm is not None and reps > 1:
        perm = (perm.reshape(-1, 1) * reps +
                torch.arange(reps, device=perm.device)).reshape(-1)
    fn = ref.act_quant_rows_ref if plain else act_quant_kernel.act_quant_rows
    q, s = fn(_rows(x), qmax, perm=perm)
    return q.reshape(*lead, k), s.reshape(*lead, 1)


def quantize_activations_grouped(
        x: torch.Tensor, row_groups: RowGroups, perm: Optional[torch.Tensor],
        *, act_quants: Optional[ActQuants] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation quantization for a grouped batch, returned PERMUTED
    (group-sorted).  One distinct (a_bits, a_signed) -> one plain
    quantization; mixed widths (all signed) -> ONE per-row-range pass.
    ``act_quants`` is shared by projections reading the SAME input."""
    if act_quants is None:
        act_quants = {}
    plain = all(g.backend == "decomposed" for _, g in row_groups)
    configs = tuple(dict.fromkeys((g.a_bits, g.a_signed)
                                  for _, g in row_groups))
    if len(configs) == 1:
        q, s = _quantize_shared(x, *configs[0], plain, act_quants)
        if perm is not None:
            q = q.index_select(0, perm)
            s = s.index_select(0, perm)
        return q, s
    if not all(g.a_signed for _, g in row_groups):
        raise ValueError("mixed activation widths fuse only for signed "
                         "activations (per-row qmin = -qmax - 1)")
    key = ("rows", plain) + tuple((rows, g.a_bits) for rows, g in row_groups)
    if key not in act_quants:
        act_quants[key] = _quantize_activations_rows(x, row_groups, perm,
                                                     plain=plain)
    return act_quants[key]


def fused_decode_linear(x: torch.Tensor, qw: QuantizedWeight,
                        row_groups: RowGroups, perm: Optional[torch.Tensor],
                        *, act_quants: Optional[ActQuants] = None,
                        pre_quant: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The fused mixed-tier decode hot path, in two launches: ONE
    activation quantization over the whole batch, then ONE group-switching
    plane-prefix GEMM with both scales applied in its epilogue.  Returns
    results in PERMUTED (group-sorted) order.

    ``pre_quant`` supplies already-quantized PERMUTED ``(codes, scales)``
    and skips the quantization: the tensor-parallel path quantizes with a
    mesh-shared range and gathers the codes, then lands here so its shards
    run this same GEMM and epilogue."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    backends = tuple(dict.fromkeys(g.backend for _, g in row_groups))
    if len(backends) != 1 or backends[0] not in INTEGER_BACKENDS:
        raise ValueError("fused grouped matmul needs one integer backend "
                         f"across groups, got {backends}")
    if pre_quant is not None:
        x_q, x_s = pre_quant
    else:
        x_q, x_s = quantize_activations_grouped(x, row_groups, perm,
                                                act_quants=act_quants)
    k, n = qw.kn
    lead = x_q.shape[:-1]
    reps = 1
    for d in lead[1:]:
        reps *= d
    eff_list = tuple(min(g.w_bits, qw.w_bits) for _, g in row_groups)
    counts = _group_plane_counts(qw, eff_list)
    plane_groups = tuple((rows * reps, p)
                         for (rows, _), p in zip(row_groups, counts))
    mult, row_group = _group_tables(plane_groups, x.device)
    pmax = int(mult.shape[1])
    # One effective per-channel scale row per group; row_group names each
    # flat row's group.
    ws = qw.group_scales(eff_list)
    x2 = x_q.reshape(-1, k).contiguous()
    s2 = x_s.reshape(-1, 1).contiguous()
    if backends[0] == "decomposed":       # unpacks a packed store
        out = ref.grouped_dequant_matmul_ref(x2, qw.get_planes_msb()[:pmax],
                                             mult, s2, ws, row_group,
                                             out_dtype)
    else:
        out = gmm.grouped_dequant_matmul(x2, _msb_prefix(qw, pmax), mult, s2,
                                         ws, row_group,
                                         out_dtype=out_dtype,
                                         **_store_args(qw))
    return out.reshape(*lead, n)


def matmul(x: torch.Tensor, w: Optional[torch.Tensor], prec: LayerPrecision,
           *, qw: Optional[QuantizedWeight] = None,
           a_signed: Optional[bool] = None,
           row_groups: Optional[RowGroups] = None,
           perm: Optional[torch.Tensor] = None,
           fused: Optional[bool] = None,
           act_quants: Optional[ActQuants] = None) -> torch.Tensor:
    """The framework's matmul: y = x @ w under a mixed-precision policy.

    x f32/bf16 [..., K]; ``w`` float [K, N] (dense / fake_quant) or ``qw``
    (prepared planes, integer backends).  ``row_groups`` (tuple of
    ``(rows, LayerPrecision)``) is the mixed-tier decode path: the batch's
    rows viewed through ``perm`` form contiguous tier groups, each run at
    ITS precision against the shared superplane store; results come back
    IN PERMUTED ORDER.  ``fused``: None fuses whenever eligible, False
    forces the per-group reference loop.  ``act_quants`` is shared by
    projections reading the SAME ``x``: each quantizes it once."""
    if row_groups is not None:
        if qw is None:
            raise ValueError("row_groups needs a prepared weight (qw)")
        total = sum(r for r, _ in row_groups)
        if total != x.shape[0]:
            raise ValueError(f"row_groups cover {total} rows, x leading "
                             f"axis is {x.shape[0]}")
        if len(row_groups) == 1:
            y = matmul(x, None, row_groups[0][1], qw=qw,
                       act_quants=act_quants)
            return y if perm is None else y.index_select(0, perm)
        eligible = (
            len({g.backend for _, g in row_groups}) == 1
            and row_groups[0][1].backend in INTEGER_BACKENDS
            and all(g.a_signed for _, g in row_groups))
        use_fused = eligible if fused is None else fused
        if use_fused:
            return fused_decode_linear(x, qw, row_groups, perm,
                                       act_quants=act_quants,
                                       out_dtype=x.dtype)
        # Per-group reference path: one full-batch activation quantization
        # per distinct a-config on the UN-permuted x, then one plane-prefix
        # GEMM per group.
        quants: Dict[Tuple[int, bool], Tuple[torch.Tensor, torch.Tensor]] = {}
        for _, gprec in row_groups:
            gkey = (gprec.a_bits, gprec.a_signed)
            if gkey not in quants:
                q, s = quantize_activations(
                    x, gprec.a_bits, signed=gprec.a_signed,
                    plain=gprec.backend == "decomposed")
                if perm is not None:
                    q = q.index_select(0, perm)
                    s = s.index_select(0, perm)
                quants[gkey] = (q, s)
        outs = []
        off = 0
        for rows, gprec in row_groups:
            x_q, x_s = quants[(gprec.a_bits, gprec.a_signed)]
            outs.append(dequant_matmul(x_q[off:off + rows], x_s[off:off + rows],
                                      qw, gprec, x.dtype))
            off += rows
        return torch.cat(outs, dim=0)
    a_signed = prec.a_signed if a_signed is None else a_signed
    backend = prec.backend
    if backend == "dense":
        assert w is not None
        return torch.matmul(x, w.to(x.dtype))
    if backend == "fake_quant":
        assert w is not None
        wcfg = quant.QuantConfig(bits=prec.w_bits, signed=prec.w_signed,
                                 per_channel=True, channel_axis=-1)
        acfg = quant.QuantConfig(bits=prec.a_bits, signed=a_signed,
                                 per_channel=False)
        wq = quant.fake_quant(w.to(torch.float32), wcfg).to(x.dtype)
        xq = quant.fake_quant(x.to(torch.float32), acfg).to(x.dtype)
        return torch.matmul(xq, wq)
    if qw is None:
        assert w is not None
        qw = prepare_weight(w.to(torch.float32), prec)
    return _integer_matmul(x, qw, prec, a_signed, act_quants)


def _integer_matmul(x: torch.Tensor, qw: QuantizedWeight,
                    prec: LayerPrecision, a_signed: bool,
                    act_quants: Optional[ActQuants] = None) -> torch.Tensor:
    """Shared integer path: act-quant + plane-prefix GEMM + dequant.  The
    grouped path quantizes the full un-permuted batch with this same code
    and only gathers results, so its rows are bitwise identical."""
    x_q, x_s = _quantize_shared(x, prec.a_bits, a_signed,
                                prec.backend == "decomposed", act_quants)
    return dequant_matmul(x_q, x_s, qw, prec, x.dtype)


def dequant_matmul(x_q: torch.Tensor, x_s: torch.Tensor, qw: QuantizedWeight,
                   prec: LayerPrecision, out_dtype: torch.dtype
                   ) -> torch.Tensor:
    """Plane-prefix GEMM on quantized activations + scale-out, the tail of
    the integer path (public for codes quantized elsewhere).  The effective
    width is the policy's ``w_bits`` (at most the stored one)."""
    backend = prec.backend
    eff_bits = min(prec.w_bits, qw.w_bits)
    if eff_bits != qw.w_bits and not qw.msb_first:
        raise ValueError(
            f"policy asks {eff_bits}b from a fixed {qw.w_bits}b weight; "
            "runtime truncation needs a superplane store "
            "(ops.prepare_superplane)")
    if backend == "decomposed":
        planes = qw.get_planes()
        if qw.msb_first:
            planes = decompose.superplane_prefix(planes, eff_bits).flip(0)
        acc = decompose.decomposed_matmul(x_q, planes, eff_bits)
    elif backend == "cuda":
        acc = bitserial_matmul_planes(x_q, qw, eff_bits=eff_bits)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    w_s = qw.eff_scale(eff_bits) if eff_bits != qw.w_bits else qw.scale
    return (acc.to(torch.float32) * x_s * w_s).to(out_dtype)
