"""Model building blocks (port of ``repro.models.layers``): norms, RoPE,
the quantized linear, flash attention, the KV cache, the SwiGLU MLP.

Every projection routes through ``kernels.ops.matmul`` under the layer's
``LayerPrecision``.  Unlike the reference, which is functional, the KV cache
is updated IN PLACE: a slot view (``serve.slots.slot_view``) shares storage
with the arena, so a prefill or decode write lands in the arena directly
and no copy of the cache is ever made.

Float work follows the reference's dtypes and rounding points: rmsnorm
rounds ``x * inv`` (then ``* g``) in bf16, attention scores and softmax
are f32 with probabilities cast to bf16 before the PV product, and the MLP
computes silu in f32 before casting to bf16.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.policy import (INTEGER_BACKENDS, LayerPrecision,
                                     PrecisionPolicy, PrecisionSchedule)
from repro_torch.distributed import tp_serve
from repro_torch.kernels import _build, ops


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Per-call execution context threaded through the model.

    Precision comes from a fixed ``policy`` or from a ``schedule`` plus
    tier information: ``tier`` (the whole batch at one tier, see
    :meth:`for_tier`) or ``groups`` + ``perm`` (a mixed-tier decode batch,
    see :meth:`for_groups`).  ``groups`` is a tuple of ``(tier_name, rows)``
    describing contiguous tier-sorted slot groups; ``perm``/``inv_perm``
    are int64 [B] tensors mapping batch rows into and out of that order.
    ``fused`` selects ONE group-switching GEMM per projection (default)
    over the per-group reference loop.  ``moe_dropless`` gives every MoE
    layer a capacity of the whole sequence (no token is dropped).  ``tp``
    (a ``distributed.tp_serve.TPConfig``) is set on a mesh engine: params
    are this rank's shards, attention sees local head counts and the o/down
    projections take the quantized-gather path.  ``rec`` (a
    ``telemetry.trace.Tracer``) is set on a traced call (``LM`` sets it
    from the process's recorder slot): the blocks record their spans into
    it."""

    policy: PrecisionPolicy
    moe_dropless: bool = False
    schedule: Optional[PrecisionSchedule] = None
    tier: Optional[str] = None
    groups: Optional[tuple] = None
    perm: Optional[torch.Tensor] = None
    inv_perm: Optional[torch.Tensor] = None
    fused: bool = True
    tp: Optional[Any] = None
    rec: Optional[Any] = None

    def prec(self, name: str) -> LayerPrecision:
        if self.schedule is not None:
            return self.schedule.lookup(name, self.tier)
        return self.policy.lookup(name)

    def for_tier(self, tier: Optional[str]) -> "Runtime":
        """This runtime with the active tier swapped (no-op sans schedule)."""
        if self.schedule is None:
            return self
        return dataclasses.replace(self, tier=tier, groups=None, perm=None,
                                   inv_perm=None)

    def for_groups(self, groups, perm: torch.Tensor) -> "Runtime":
        """This runtime serving a mixed-tier batch: ``perm[i]`` is the batch
        row that sorted position ``i`` reads from."""
        if self.schedule is None:
            raise ValueError("mixed-tier groups need a PrecisionSchedule")
        return dataclasses.replace(self, tier=None, groups=tuple(groups),
                                   perm=perm, inv_perm=torch.argsort(perm))

    @property
    def group_batch(self) -> int:
        """Total rows covered by ``groups`` (the slot-batch size)."""
        return sum(n for _, n in self.groups)


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device) -> Dict[str, Any]:
    """U(-1/sqrt(in), 1/sqrt(in)) in f32, cast to ``dtype`` (the reference's
    distribution; the draws differ, tests convert the reference's weights)."""
    scale = 1.0 / math.sqrt(in_dim)
    u = torch.rand((in_dim, out_dim), generator=gen, device=device,
                   dtype=torch.float32)
    return {"w": (u * (2.0 * scale) - scale).to(dtype)}


@functools.lru_cache(maxsize=256)
def _serve_backend(prec: LayerPrecision) -> LayerPrecision:
    """Prepared weights only run on the integer serving backends."""
    return prec.with_backend(prec.backend if prec.backend in INTEGER_BACKENDS
                             else "decomposed")


def linear(params: Dict[str, Any], x: torch.Tensor, rt: Runtime, name: str,
           *, act_quants: Optional[Dict[Any, Any]] = None) -> torch.Tensor:
    """y = x @ w under the mixed-precision policy (``w`` may be a prepared
    QuantizedWeight).  Under a mixed-tier runtime every prepared-weight
    matmul takes the per-row-group path: rows gathered into tier order
    inside ``ops.matmul``, results scattered back with ``rt.inv_perm``.
    ``act_quants`` is shared by projections reading the SAME tensor.
    Under ``rt.tp`` the o/down projections read feature-sharded inputs and
    take ``distributed.tp_serve``'s gathered matmuls.  Under ``rt.rec`` a
    prepared-weight matmul records a ``linear`` span: ``name``, ``rows``
    and ``launches``, the hand-written kernels it launched."""
    w = params["w"]
    if not isinstance(w, ops.QuantizedWeight):
        y = ops.matmul(x, w, rt.prec(name))
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y
    if rt.groups is not None and x.shape[0] != rt.group_batch:
        raise ValueError(
            f"{name}: mixed-tier groups cover {rt.group_batch} slots "
            f"but x has leading axis {x.shape[0]}")
    rec = rt.rec
    if rec is not None:
        span = rec.begin("linear", name=name, rows=x.numel() // x.shape[-1])
        launched = _build.launch_total()
    gathered = rt.tp is not None and rt.tp.gathers(name)
    if rt.groups is None or len(rt.groups) == 1:   # one tier: no permuting
        prec = _serve_backend(rt.prec(name) if rt.groups is None else
                              rt.schedule.lookup(name, rt.groups[0][0]))
        if gathered:
            y = tp_serve.gathered_matmul(x, w, prec, tp=rt.tp)
        else:
            y = ops.matmul(x, None, prec, qw=w, act_quants=act_quants)
    else:
        row_groups = tuple(
            (n, _serve_backend(rt.schedule.lookup(name, t)))
            for t, n in rt.groups)
        if gathered:
            y = tp_serve.gathered_grouped_matmul(x, w, row_groups, rt.perm,
                                                 tp=rt.tp)
        else:
            y = ops.matmul(x, None, row_groups[0][1], qw=w,
                           row_groups=row_groups, perm=rt.perm,
                           fused=None if rt.fused else False,
                           act_quants=act_quants)
        y = y.index_select(0, rt.inv_perm)
    if rec is not None:
        rec.end(span, launches=_build.launch_total() - launched)
    return y


# --------------------------------------------------------------------- norms
def rmsnorm_init(dim: int, dtype: torch.dtype,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Variance in f32; the normalized product stays in x.dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return x * inv.to(x.dtype) * params["g"].to(x.dtype)


def qk_headnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over head_dim (Qwen3 qk_norm). x: [..., H, Dh]."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> torch.Tensor:
    """Rotary embedding, split-half convention. x: [B, S, H, Dh]."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    angles = positions.to(torch.float32)[..., None] * freqs      # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- flash attention
NEG = -1e30


def _whole_heads(t: torch.Tensor, tp) -> torch.Tensor:
    """This rank's heads [B, S, H/n, Dh] in their place among zero heads
    [B, S, H, Dh]."""
    hl = t.shape[2]
    out = t.new_zeros((t.shape[0], t.shape[1], hl * tp.n, t.shape[3]))
    out.narrow(2, tp.rank * hl, hl).copy_(t)
    return out


def _as_unsharded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  tp, **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` on this rank's heads, computed at the unsharded
    engine's head count (``tp``: ``distributed.tp_serve.TPConfig``).

    A batched GEMM on the card takes its algorithm from the batch count,
    so attention over a rank's share of the heads would round differently
    from the same heads in the whole batch (the tensor-parallel engine
    must equal the unsharded one bit for bit).  The rank's q heads (and
    its K/V heads, when they are sharded) are placed among zero heads, so
    every product is the unsharded engine's call, and its own heads are
    read back: the rank does the whole layer's attention arithmetic (the
    projections stay split)."""
    if tp is None:
        return fn(q, k, v, **kw)
    hl = q.shape[2]
    q = _whole_heads(q, tp)
    if tp.kv_shards:
        k, v = _whole_heads(k, tp), _whole_heads(v, tp)
    return fn(q, k, v, **kw).narrow(2, tp.rank * hl, hl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_k: int = 1024,
                    q_offset: int = 0, tp=None) -> torch.Tensor:
    """Online-softmax attention over K/V blocks of ``block_k`` (plain
    torch; the reference's blocked recurrence, block for block).

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KVH, Dh], H % KVH == 0 (GQA).
    Returns [B, Sq, H, Dh] in q.dtype.  ``tp``: this rank's heads, see
    :func:`_as_unsharded`."""
    if tp is not None:
        return _as_unsharded(flash_attention, q, k, v, tp, causal=causal,
                             block_k=block_k, q_offset=q_offset)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).to(torch.float32)                     # [b, h, sq, dh]
    block_k = min(block_k, sk)
    nb = -(-sk // block_k)
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for i in range(nb):
        kpos = i * block_k + torch.arange(block_k, device=dev)
        kb = k[:, i * block_k:(i + 1) * block_k].to(torch.float32)
        vb = v[:, i * block_k:(i + 1) * block_k].to(torch.float32)
        pad = block_k - kb.shape[1]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bhqd,bshd->bhqs", qf, kb) * scale
        valid = (kpos < sk)[None, :]
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        s = s.masked_fill(~valid[None, None], NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqs,bshd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ------------------------------------------------------------------ KV cache
# KV storage modes: a cache is homogeneous (bf16; int8 codes; int4 codes
# packed two to a byte, each with per-(position, head) bf16 scales) or a
# MIXED per-slot byte-lane arena: uint8 lanes [B, Smax, KVH, L] wide enough
# for the widest mode served, a per-slot tier code ``kv_bits`` int32 [B]
# (16 = bf16 bytes, 8, 4) and shared scale rows.  A mixed slot stores
# exactly the bytes of the homogeneous cache at its code, so a request's
# tokens do not depend on its neighbours' KV precision.

KV_TIER_BITS = (16, 8, 4)     # bf16 bytes, int8, int4 packed


def _kv_lane_bytes(bits: int, head_dim: int) -> int:
    """Bytes one (position, head) row takes at a tier code."""
    return {16: 2 * head_dim, 8: head_dim, 4: head_dim // 2}[bits]


def _kv_quant(x: torch.Tensor, bits: int, scale_dtype: torch.dtype):
    """Symmetric per-(position, head) KV quantization (int8 codes in
    [-2^(bits-1), 2^(bits-1) - 1]), for every mode that quantizes.

    The scale is ``amax * (1/qmax)``: the reference writes ``/ qmax`` but
    runs it jitted, where XLA turns the division by a constant into this
    reciprocal multiply, and the port follows what the reference serves."""
    x = x.to(torch.float32)
    qmax = (1 << (bits - 1)) - 1
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * float(np.float32(1.0) / np.float32(qmax))
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(scale_dtype)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] [..., Dh] -> uint8 [..., Dh//2]: element 2i
    in the low nibble, 2i+1 in the high one."""
    u = q.view(torch.uint8)
    return (u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)


def _unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_int4` (sign-extended int8 [..., Dh])."""
    lo = (b & 0xF).to(torch.int32)
    hi = ((b >> 4) & 0xF).to(torch.int32)
    both = torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], -1)
    return torch.where(both >= 8, both - 16, both).to(torch.int8)


def _bf16_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """bf16 [..., Dh] -> its bytes, little end first, uint8 [..., 2*Dh]."""
    return x.to(torch.bfloat16).contiguous().view(torch.uint8)


def _bytes_to_bf16(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_bf16_to_bytes`."""
    return b.contiguous().view(torch.bfloat16)


@dataclasses.dataclass
class KVCache:
    """Pre-allocated KV cache with PER-SLOT lengths and, in the mixed mode,
    PER-SLOT tier codes.  Slot axis first: [B, Smax, KVH, lanes].  All
    writes are in place (see the module docstring).

    Homogeneous: bf16 [.., Dh]; int8 codes [.., Dh]; int4 nibbles uint8
    [.., Dh//2] — quantized modes with bf16 scales [B, Smax, KVH, 1].
    Mixed: uint8 lanes, ``kv_bits`` int32 [B] and ``modes`` (the codes the
    arena serves, descending); each slot encodes and decodes at its own
    code, every mode computed and the slot's one selected per slot (no
    host read of ``kv_bits``)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]   # bf16 [B, Smax, KVH, 1] when quantized
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor              # int32 [B] — filled positions per slot
    kv_bits: Optional[torch.Tensor] = None   # int32 [B] tier codes (mixed)
    modes: Optional[tuple] = None            # codes served, descending

    # The tensor fields, in the reference's pytree order (its data fields).
    FIELDS = ("k", "v", "k_scale", "v_scale", "length", "kv_bits")

    @property
    def quantized(self) -> bool:
        """Homogeneous int8 storage."""
        return self.k.dtype == torch.int8

    @property
    def packed4(self) -> bool:
        """Homogeneous int4 nibble storage."""
        return self.k.dtype == torch.uint8 and self.kv_bits is None

    @property
    def mixed(self) -> bool:
        """Per-slot tiered byte-lane arena."""
        return self.kv_bits is not None

    @property
    def head_dim(self) -> int:
        lanes = self.k.shape[-1]
        if self.mixed:
            return {16: lanes // 2, 8: lanes, 4: 2 * lanes}[self.modes[0]]
        return 2 * lanes if self.packed4 else lanes

    @staticmethod
    def create(batch: int, max_len: int, kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16, kv_bits: Any = None,
               device: Optional[torch.device] = None) -> "KVCache":
        """``kv_bits``: None (bf16), 8 (int8), 4 (int4 packed), or a tuple
        of codes from ``KV_TIER_BITS`` for the mixed arena (lanes sized for
        the widest code; every slot starts at it)."""
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)

        def s():
            return torch.ones((batch, max_len, kv_heads, 1),
                              dtype=torch.bfloat16, device=device)

        def z(lanes: int, dt: torch.dtype) -> torch.Tensor:
            return torch.zeros((batch, max_len, kv_heads, lanes), dtype=dt,
                               device=device)
        if isinstance(kv_bits, (tuple, list)):
            modes = tuple(sorted({int(m) for m in kv_bits}, reverse=True))
            if not modes or any(m not in KV_TIER_BITS for m in modes):
                raise ValueError(f"mixed kv tiers must be from "
                                 f"{KV_TIER_BITS}, got {kv_bits}")
            if head_dim % 2:
                raise ValueError("per-slot KV tiers need an even head_dim")
            lanes = max(_kv_lane_bytes(m, head_dim) for m in modes)
            tiers = torch.full((batch,), modes[0], dtype=torch.int32,
                               device=device)
            return KVCache(z(lanes, torch.uint8), z(lanes, torch.uint8), s(),
                           s(), lengths, kv_bits=tiers, modes=modes)
        if kv_bits == 8:
            return KVCache(z(head_dim, torch.int8), z(head_dim, torch.int8),
                           s(), s(), lengths)
        if kv_bits == 4:
            if head_dim % 2:
                raise ValueError("int4 KV packing needs an even head_dim")
            return KVCache(z(head_dim // 2, torch.uint8),
                           z(head_dim // 2, torch.uint8), s(), s(), lengths)
        if kv_bits is not None:
            raise ValueError(f"kv_bits must be None, 8, 4 or a tier tuple, "
                             f"got {kv_bits!r}")
        return KVCache(z(head_dim, dtype), z(head_dim, dtype), None, None,
                       lengths)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the cache (the state a slot holds)."""
        return [t for t in (getattr(self, f) for f in self.FIELDS)
                if t is not None]

    def slot(self, slot: int) -> "KVCache":
        """A batch-1 view of one slot; writes through it land in self."""
        sl = slice(slot, slot + 1)
        return KVCache(*[None if t is None else t[sl] for t in (
            getattr(self, f) for f in self.FIELDS)], modes=self.modes)

    # ------------------------------------------------- mixed-mode encoding
    def _slot_select(self, per_mode: List[torch.Tensor]) -> torch.Tensor:
        """Each slot's candidate, chosen by its ``kv_bits`` code (a code
        outside ``modes``, e.g. the zero of a fresh arena, takes the last)."""
        kv = self.kv_bits.reshape((-1,) + (1,) * (per_mode[0].ndim - 1))
        out = per_mode[-1]
        for m, cand in zip(self.modes[:-1], per_mode[:-1]):
            out = torch.where(kv == m, cand, out)
        return out

    def _encode_mixed(self, x: torch.Tensor):
        """float [..., Dh] -> (byte lanes [..., L], scale [..., 1]), every
        slot at its own code (the homogeneous cache's bytes, zero-padded
        past the code's width)."""
        lanes = self.k.shape[-1]
        bys, scs = [], []
        for m in self.modes:
            if m == 16:
                by = _bf16_to_bytes(x)
                sc = torch.ones(x.shape[:-1] + (1,), dtype=self.k_scale.dtype,
                                device=x.device)
            else:
                q, sc = _kv_quant(x, m, self.k_scale.dtype)
                by = q.view(torch.uint8) if m == 8 else _pack_int4(q)
            pad = lanes - by.shape[-1]
            if pad:
                by = torch.nn.functional.pad(by, (0, pad))
            bys.append(by)
            scs.append(sc)
        return self._slot_select(bys), self._slot_select(scs)

    def _decode_mixed(self, buf: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """Byte lanes [..., L] -> values [..., Dh], each slot at its code."""
        dh = self.head_dim
        cands = []
        for m in self.modes:
            if m == 16:
                cands.append(_bytes_to_bf16(buf[..., :2 * dh]).to(dtype))
            else:
                q = buf[..., :dh].view(torch.int8) if m == 8 \
                    else _unpack_int4(buf[..., :dh // 2])
                cands.append(q.to(dtype) * scale.to(dtype))
        return self._slot_select(cands)

    # --------------------------------------------------------------- writes
    def _encode(self, x: torch.Tensor):
        """float K or V rows -> (storage, scale or None) for this mode."""
        if self.mixed:
            return self._encode_mixed(x)
        if self.quantized:
            return _kv_quant(x, 8, self.k_scale.dtype)
        if self.packed4:
            q, sc = _kv_quant(x, 4, self.k_scale.dtype)
            return _pack_int4(q), sc
        return x.to(self.k.dtype), None

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, start: int, *,
               new_length: Optional[torch.Tensor] = None) -> "KVCache":
        """Write [B, S_new, KVH, Dh] at position ``start``; ``new_length``
        ([B]) overrides the resulting per-slot lengths (right-padded
        prefill: only the first ``new_length[b]`` positions are real)."""
        s = k_new.shape[1]
        kq, ks = self._encode(k_new)
        vq, vs = self._encode(v_new)
        self.k[:, start:start + s] = kq
        self.v[:, start:start + s] = vq
        if ks is not None:
            self.k_scale[:, start:start + s] = ks
            self.v_scale[:, start:start + s] = vs
        if new_length is None:
            self.length.fill_(start + s)
        else:
            self.length.copy_(new_length.to(self.length.dtype)
                              .expand_as(self.length))
        return self

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> "KVCache":
        """Masked per-slot decode write: one token per slot at that slot's
        own ``length[b]``; slots with ``active[b] == False`` (or full) keep
        their K/V rows and lengths."""
        b, smax = self.k.shape[0], self.k.shape[1]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=self.k.device)
        active = active & (self.length < smax)
        idx = torch.arange(b, device=self.k.device)
        pos = torch.clamp(self.length, 0, smax - 1).to(torch.int64)

        def put(buf: torch.Tensor, val: torch.Tensor) -> None:
            cur = buf[idx, pos]
            mask = active.reshape((-1,) + (1,) * (val.ndim - 1))
            buf[idx, pos] = torch.where(mask, val.to(buf.dtype), cur)

        kq, ks = self._encode(k_new)
        vq, vs = self._encode(v_new)
        put(self.k, kq[:, 0])
        put(self.v, vq[:, 0])
        if ks is not None:
            put(self.k_scale, ks[:, 0])
            put(self.v_scale, vs[:, 0])
        self.length.add_(active.to(self.length.dtype))
        return self

    def requantize(self, kv_bits_new: int) -> "KVCache":
        """Re-encode the stored K/V at the tier code ``kv_bits_new``, in
        place (mixed mode only): the KV half of a mid-stream tier migration.

        Every lane, past the lengths included, is read at its CURRENT code
        (as bf16, through :meth:`read`) and written through ``_encode`` at
        the new one: the bytes a cache at the new code would hold had it
        been given the dequantized values.  Every slot of this cache moves
        to the one code and lengths stay; callers migrate one slot through
        a slot view."""
        if not self.mixed:
            raise ValueError("requantize() needs the mixed per-slot KV "
                             "arena (kv_bits tier codes)")
        k, v = self.read(torch.bfloat16)
        self.kv_bits.fill_(int(kv_bits_new))
        kq, ks = self._encode(k)
        vq, vs = self._encode(v)
        for dst, src in ((self.k, kq), (self.v, vq), (self.k_scale, ks),
                         (self.v_scale, vs)):
            dst.copy_(src)
        return self

    def read(self, dtype: torch.dtype = torch.bfloat16):
        """Dequantized (K, V) of the whole arena."""
        if self.mixed:
            return (self._decode_mixed(self.k, self.k_scale, dtype),
                    self._decode_mixed(self.v, self.v_scale, dtype))
        if self.quantized:
            return (self.k.to(dtype) * self.k_scale.to(dtype),
                    self.v.to(dtype) * self.v_scale.to(dtype))
        if self.packed4:
            return (_unpack_int4(self.k).to(dtype) * self.k_scale.to(dtype),
                    _unpack_int4(self.v).to(dtype) * self.v_scale.to(dtype))
        return self.k.to(dtype), self.v.to(dtype)


def softmax(s: torch.Tensor) -> torch.Tensor:
    """``exp(s - max) / sum`` with a true division (the reference's form)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def decode_attention(q: torch.Tensor, cache: KVCache, *,
                     tp=None) -> torch.Tensor:
    """Single-step attention against a cache. q: [B, 1, H, Dh].  Grouped
    (kvh, g) form: scores in f32 from bf16 operands, per-slot length mask,
    probabilities cast to bf16 before the PV product (f32 accumulation).
    ``tp``: this rank's heads, see :func:`_as_unsharded`."""
    k, v = cache.read(q.dtype)
    return _as_unsharded(_decode_core, q, k, v, tp, length=cache.length)


def _decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 length: torch.Tensor) -> torch.Tensor:
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid = torch.arange(sk, device=q.device)[None, :] < length[:, None]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG)
    p = softmax(s)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


# --------------------------------------------------------------- GQA attention
def attention_init(gen: torch.Generator, cfg, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, Any]:
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "q_proj": dense_init(gen, d, h * dh, dtype, device),
        "k_proj": dense_init(gen, d, kvh * dh, dtype, device),
        "v_proj": dense_init(gen, d, kvh * dh, dtype, device),
        "o_proj": dense_init(gen, h * dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"g": torch.ones((dh,), dtype=dtype, device=device)}
        p["k_norm"] = {"g": torch.ones((dh,), dtype=dtype, device=device)}
    return p


def per_position(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each window position of ``xs`` ([B, S, ...]) as
    its own contiguous [B, 1, ...] tensors — the shape and layout a decode
    step gives it — with the results concatenated on axis 1.  A row's bits
    then never depend on how many rows share the call: a reduction over
    more rows may take another split (the card's launch configuration
    follows the output count), and an elementwise transcendental another
    code path (a vector loop's scalar tail on the CPU)."""
    s = xs[0].shape[1]
    if s == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[:, j:j + 1].contiguous() for x in xs))
                      for j in range(s)], dim=1)


def attention_apply(params: Dict[str, Any], x: torch.Tensor, rt: Runtime,
                    cfg, name: str, *, positions: Optional[torch.Tensor] = None,
                    cache: Optional[KVCache] = None, cache_start=None,
                    seq_lengths: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    verify_window: bool = False):
    """GQA attention with RoPE (+ optional qk_norm).  With ``cache``: S > 1
    prefills the cache from position 0 (``seq_lengths`` [B] are the true
    token counts of right-padded prompts); S == 1 appends one token at
    each slot's own fill point, ``active`` [B] masking the writes.

    ``verify_window`` (the speculative verify): S > 1 tokens append at each
    slot's own fill point.  q/k/v/o run batched over the window (B*S rows;
    per-row quantization and exact integer sums make each row equal to a
    decode step's), while qk_norm, RoPE and the core replay one decode
    step per position (``append`` + ``decode_attention`` on [B, 1] slices),
    so position j's output and KV write are bit-identical to the j-th
    sequential decode step.  Under ``rt.rec`` the path outside a verify
    window records ``rope`` (q and k), ``kv_write`` (the cache append or
    update) and ``attn_core`` (the cache read, the products and the
    softmax).  Returns (out, cache)."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if rt.tp is not None:
        # This rank's heads: a contiguous query-head slice maps onto the
        # matching KV-head slice (kv_shards) or onto the one replicated
        # MQA head, so the GQA grouping follows from the local counts.
        h //= rt.tp.n
        if rt.tp.kv_shards:
            kvh //= rt.tp.n
    if positions is None:
        if cache_start is not None:
            base = torch.as_tensor(cache_start, dtype=torch.int32,
                                   device=x.device).reshape(-1, 1)
        elif cache is not None and (s == 1 or verify_window):
            base = cache.length[:, None]
        else:
            base = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
        positions = base + torch.arange(s, dtype=torch.int32,
                                        device=x.device)[None, :]
        positions = positions.expand(b, s)
    acts: Dict[Any, Any] = {}
    q = linear(params["q_proj"], x, rt, f"{name}.q_proj",
               act_quants=acts).reshape(b, s, h, dh)
    k = linear(params["k_proj"], x, rt, f"{name}.k_proj",
               act_quants=acts).reshape(b, s, kvh, dh)
    v = linear(params["v_proj"], x, rt, f"{name}.v_proj",
               act_quants=acts).reshape(b, s, kvh, dh)
    if verify_window and cache is not None and s > 1:
        def step(q_t, k_t, v_t, pos_t):
            if cfg.qk_norm:
                q_t = qk_headnorm(params["q_norm"], q_t)
                k_t = qk_headnorm(params["k_norm"], k_t)
            q_t = rope(q_t, pos_t, cfg.rope_theta)
            cache.append(rope(k_t, pos_t, cfg.rope_theta), v_t,
                         active=active)
            return decode_attention(q_t, cache, tp=rt.tp)
        out = per_position(step, q, k, v, positions.contiguous())
        out = out.reshape(b, s, h * dh)
        return linear(params["o_proj"], out, rt, f"{name}.o_proj"), cache
    if cfg.qk_norm:
        q = qk_headnorm(params["q_norm"], q)
        k = qk_headnorm(params["k_norm"], k)
    rec = rt.rec
    if rec is not None:
        span = rec.begin("rope")
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if rec is not None:
        rec.end(span)
    if cache is not None:
        if rec is not None:
            span = rec.begin("kv_write")
        start = 0 if cache_start is None else cache_start
        if s == 1:
            cache.append(k, v, active=active)
        else:
            cache.update(k, v, start, new_length=seq_lengths)
        if rec is not None:
            rec.end(span)
            span = rec.begin("attn_core")
        if s == 1:
            out = decode_attention(q, cache, tp=rt.tp)
        else:
            kf, vf = cache.read(q.dtype)
            out = flash_attention(q, kf, vf, causal=True, q_offset=start,
                                  tp=rt.tp)
    else:
        if rec is not None:
            span = rec.begin("attn_core")
        if rt.groups is not None and len(rt.groups) > 1:
            # Each row group of a mixed-tier layout attends as a batch of
            # its own, so its bits equal a forward of that group alone: the
            # card's batched GEMMs choose their algorithm by the batch
            # count.
            sizes = [n for _, n in rt.groups]
            out = torch.cat([
                flash_attention(*t, causal=True, tp=rt.tp)
                for t in zip(q.split(sizes), k.split(sizes), v.split(sizes))])
        else:
            out = flash_attention(q, k, v, causal=True, tp=rt.tp)
    if rec is not None:
        rec.end(span)
    out = out.reshape(b, s, h * dh)
    return linear(params["o_proj"], out, rt, f"{name}.o_proj"), cache


# ----------------------------------------------------------------- SwiGLU MLP
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device) -> Dict[str, Any]:
    return {
        "gate_proj": dense_init(gen, d_model, d_ff, dtype, device),
        "up_proj": dense_init(gen, d_model, d_ff, dtype, device),
        "down_proj": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_apply(params: Dict[str, Any], x: torch.Tensor, rt: Runtime,
              name: str, *, verify_window: bool = False) -> torch.Tensor:
    """SwiGLU MLP.  ``verify_window``: the activation runs per window
    position (:func:`per_position`), the projections batched."""
    acts: Dict[Any, Any] = {}
    gate = linear(params["gate_proj"], x, rt, f"{name}.gate_proj",
                  act_quants=acts)
    up = linear(params["up_proj"], x, rt, f"{name}.up_proj", act_quants=acts)
    if verify_window:
        hidden = per_position(lambda g, u: _swiglu(g, u, x.dtype), gate, up)
    else:
        hidden = _swiglu(gate, up, x.dtype)
    return linear(params["down_proj"], hidden, rt, f"{name}.down_proj")


def _swiglu(gate: torch.Tensor, up: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """silu(gate) in f32, cast to ``dtype``, times ``up``."""
    gf = gate.to(torch.float32)
    return (gf * torch.sigmoid(gf)).to(dtype) * up
