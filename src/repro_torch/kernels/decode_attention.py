"""Single-token decode attention over the KV arena: the wrapper of
``csrc/decode_attention.cu``.

Replaces no TPU kernel: the reference's decode attention is plain jnp.
On the card it takes the place of ``KVCache.read`` (the whole arena cast
to the query's dtype) and ``models.layers._decode_core`` (f32 einsums and
the softmax), which stay the plain version: ``layers.decode_attention``
runs them for a CPU (or meta) tensor and this wrapper for a CUDA one,
which launches the kernel or raises.  The kernel reads the cache's own
storage in place through its strides (bf16; int8 or int4 codes with
their bf16 scales; the mixed byte-lane arena, each slot at its own
``kv_bits`` code), so a slot view or a head slice needs no copy, and
each slot only up to its own length.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 128, 160)      # the kernel's instantiations
# id(cache) -> (weak ref to the cache, (B, H, Dh, device), weak refs to its
# tensors, the launch arguments _cache_args made from them).
_CHECKED: Dict[int, tuple] = {}
_CODE_FLAG = {16: 1, 8: 2, 4: 4}
_INT32_MAX = (1 << 31) - 1


def _storage(cache) -> tuple:
    """(mode, modes_mask, last_mode, widest code): the C entry's storage
    arguments, and the code whose rows are the widest the kernel reads."""
    if cache.kv_bits is not None:
        modes = tuple(cache.modes)
        mask = sum(_CODE_FLAG[m] for m in modes[:-1])
        return 0, mask, modes[-1], max(modes)
    mode = {torch.bfloat16: 16, torch.int8: 8, torch.uint8: 4}.get(
        cache.k.dtype)
    if mode is None:
        raise ValueError(f"decode_attention: a {cache.k.dtype} cache has no "
                         "storage code (bf16, int8 codes, int4 nibbles or "
                         "the mixed arena)")
    return mode, 0, 0, mode


def _rows(t: torch.Tensor, name: str, device, width: int) -> tuple:
    """K's or V's (slot, position, head) strides in bytes; its lanes must
    be contiguous and every row start on a ``width``-byte boundary (the
    kernel's vector loads)."""
    es = t.element_size()
    s0, s1, s2, s3 = t.stride()
    sb, ss, sh = s0 * es, s1 * es, s2 * es
    if t.device != device or (s3 != 1 and t.shape[3] > 1) \
            or (t.data_ptr() | sb | ss | sh) % width \
            or min(sb, ss, sh) < 0 or max(sb, ss, sh) > _INT32_MAX:
        raise ValueError(f"decode_attention: {name} must lie on {device} "
                         f"with contiguous lanes and rows on {width}-byte "
                         f"boundaries, got strides {t.stride()} on "
                         f"{t.device}")
    return sb, ss, sh


def _scale(t, name: str, shape: tuple, device) -> tuple:
    """A scale's (slot, position, head) strides in elements."""
    if t is None or t.dtype != torch.bfloat16 or t.shape != shape \
            or t.device != device:
        raise ValueError(f"decode_attention: {name} must be bf16 "
                         f"{list(shape)} on {device}")
    st = t.stride()[:3]
    if min(st) < 0 or max(st) > _INT32_MAX:
        raise ValueError(f"decode_attention: {name}'s strides {t.stride()} "
                         "do not fit the kernel's int strides")
    return st


def _check_vector(t, name: str, b: int, device) -> None:
    if t.dtype != torch.int32 or t.shape != (b,) or t.device != device \
            or (b > 1 and t.stride(0) != 1):
        raise ValueError(f"decode_attention: {name} must be a contiguous "
                         f"int32 [{b}] on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _cache_args(q: torch.Tensor, cache) -> tuple:
    """Checks ``cache`` against the kernel's layout for ``q``'s shape and
    returns the C entry's arguments that depend on the cache alone: its
    pointers, then KVH, Smax, the storage arguments and every stride."""
    k, v = cache.k, cache.v
    b, _, h, dh = q.shape
    shape = k.shape
    if len(shape) != 4 or v.shape != shape or v.dtype != k.dtype \
            or shape[0] != b or not shape[2] or h % shape[2]:
        raise ValueError(f"decode_attention: K/V {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not serve q {tuple(q.shape)} "
                         "([B, Smax, KVH, lanes], H a multiple of KVH)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head size {dh}; the kernel has "
                         f"{HEAD_DIMS}")
    mode, mask, last, widest = _storage(cache)
    _, smax, kvh, lanes = shape
    # The widest code's row: 2 Dh bytes of bf16, Dh int8 codes, Dh / 2
    # bytes of nibbles; its vector loads are 16, 8 and 4 bytes.
    if lanes * k.element_size() < widest * dh // 8 or smax < 1:
        raise ValueError(f"decode_attention: K/V rows of {lanes} "
                         f"{k.dtype} lanes cannot hold a head of {dh} at "
                         f"code {widest} (Smax {smax})")
    dev = q.device
    k_st = _rows(k, "K", dev, widest)
    v_st = _rows(v, "V", dev, widest)
    scales, scale_st = (None, None), (0,) * 6
    if mode != 16:                # int8, int4 or the mixed arena
        sshape = (b, smax, kvh, 1)
        scale_st = _scale(cache.k_scale, "k_scale", sshape, dev) + \
            _scale(cache.v_scale, "v_scale", sshape, dev)
        scales = (cache.k_scale.data_ptr(), cache.v_scale.data_ptr())
    _check_vector(cache.length, "length", b, dev)
    kv_bits = None
    if cache.kv_bits is not None:
        _check_vector(cache.kv_bits, "kv_bits", b, dev)
        kv_bits = cache.kv_bits.data_ptr()
    return (k.data_ptr(), v.data_ptr(), *scales, cache.length.data_ptr(),
            kv_bits), (kvh, smax, mode, mask, last), k_st + v_st + scale_st


def decode_attention(q: torch.Tensor, cache) -> torch.Tensor:
    """q bf16 [B, 1, H, Dh] against ``cache`` (a ``layers.KVCache`` or a
    view of one: K/V [B, Smax, KVH, lanes], ``length`` [B]) -> bf16
    [B, 1, H, Dh]; query head ``h`` reads KV head ``h // (H / KVH)``.
    Raises for anything off the kernel's layout.

    The cache's checks and launch arguments are kept (``_CHECKED``) with
    weak references to the cache and the tensors they were made from: a
    layer's arena is the same tensors at every step, written in place, so
    a later call checks only ``q`` and that the tensors are the same."""
    b, sq, h, dh = q.shape if q.ndim == 4 else (0, 0, 0, 0)
    if q.dtype != torch.bfloat16 or sq != 1 or (dh > 1 and q.stride(3) != 1):
        raise ValueError(f"decode_attention: q must be bf16 [B, 1, H, Dh] "
                         f"with Dh contiguous, got {q.dtype} "
                         f"{tuple(q.shape)} strides {q.stride()}")
    dev = q.device
    fields = (cache.k, cache.v, cache.k_scale, cache.v_scale, cache.length,
              cache.kv_bits)
    key = (b, h, dh, dev)
    hit = _CHECKED.get(id(cache))
    if hit is None or hit[0]() is not cache or hit[1] != key or any(
            (r() if r is not None else None) is not t
            for r, t in zip(hit[2], fields)):
        hit = (weakref.ref(cache, lambda _, i=id(cache): _CHECKED.pop(i,
                                                                     None)),
               key, tuple(None if t is None else weakref.ref(t)
                          for t in fields), _cache_args(q, cache))
        _CHECKED[id(cache)] = hit
    ptrs, geo, strides = hit[3]
    _build.check_cuda(q, "decode_attention")
    out = torch.empty((b, 1, h, dh), dtype=torch.bfloat16, device=dev)
    if b == 0 or h == 0:
        return out
    kvh = geo[0]
    _build.launch("decode_attention", dev, q, *ptrs, out, b, kvh, h // kvh,
                  dh, *geo[1:], q.stride(0), q.stride(2), *strides)
    _build.LAUNCHES["decode_attention"] += 1
    return out
