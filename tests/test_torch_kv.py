"""repro_torch KV cache in its int4 and mixed per-slot modes, held against
the JITTED reference (``jax.jit`` of ``KVCache.update`` / ``append`` /
``requantize`` and of ``serve.slots``), EXACT: codes, scales, the raw lane
bytes, lengths and tier codes, and what ``read`` returns.

Why jitted: the reference writes the KV scale as ``amax / qmax`` but
serves it jitted, where XLA multiplies by ``1/qmax`` instead; the two
forms differ on many rows at 4 bits (``test_kv_quant_follows_the_jitted
_reference``), and the port takes the served form for every mode.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.serve import slots as jslots
from repro_torch.convert import to_torch
from repro_torch.models import layers as tlayers
from repro_torch.serve import slots as tslots

B, S, KVH, DH = 3, 12, 2, 16
FIELDS = ("k", "v", "k_scale", "v_scale", "length", "kv_bits")


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _cv(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _inputs(seed: int, s_new: int = 7):
    """bf16 K/V of a right-padded prefill and one decode step."""
    rng = np.random.default_rng(seed)
    shape = (B, s_new, KVH, DH)
    k, v = (jnp.asarray(rng.normal(size=shape) * 2, jnp.bfloat16)
            for _ in range(2))
    k1, v1 = (jnp.asarray(rng.normal(size=(B, 1, KVH, DH)), jnp.bfloat16)
              for _ in range(2))
    return k, v, k1, v1


def _assert_cache_equal(jc, tc, fields=FIELDS) -> None:
    for f in fields:
        want, got = getattr(jc, f), getattr(tc, f)
        if want is None:
            assert got is None, f
            continue
        np.testing.assert_array_equal(_ref(want), _np(got), err_msg=f)


def test_kv_quant_follows_the_jitted_reference():
    """At 8 and 4 bits the codes and scales equal the jitted reference's
    (reciprocal-multiply scale); at 4 bits the eager reference (a true
    division) differs on many of these rows, so the test tells the two
    forms apart."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4096, 128)),
                    jnp.float32)
    for bits in (8, 4):
        qj, sj = jax.jit(lambda a, b=bits: jlayers._kv_quant(
            a, b, jnp.bfloat16))(x)
        qt, st = tlayers._kv_quant(_cv(x), bits, torch.bfloat16)
        np.testing.assert_array_equal(_ref(qj), _np(qt))
        np.testing.assert_array_equal(_ref(sj), _np(st))
    amax = np.abs(np.asarray(x)).max(-1)
    eager = np.maximum(amax, np.float32(1e-8)) / np.float32(7)
    served = np.maximum(amax, np.float32(1e-8)) * (np.float32(1) /
                                                   np.float32(7))
    assert (eager != served).sum() > 1000


def test_int4_pack_and_bf16_bytes_match_the_reference():
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.integers(-8, 8, size=(5, 32)), jnp.int8)
    np.testing.assert_array_equal(
        _ref(jlayers._pack_int4(q)), _np(tlayers._pack_int4(_cv(q))))
    np.testing.assert_array_equal(
        np.asarray(q), _np(tlayers._unpack_int4(tlayers._pack_int4(_cv(q)))))
    x = jnp.asarray(rng.normal(size=(5, 32)), jnp.bfloat16)
    by = tlayers._bf16_to_bytes(_cv(x))
    np.testing.assert_array_equal(_ref(jlayers._bf16_to_bytes(x)), _np(by))
    np.testing.assert_array_equal(_ref(x), _np(tlayers._bytes_to_bf16(by)))


# Homogeneous int4 and mixed arenas with their per-slot codes.
MODES = [(4, None), ((16, 8, 4), (16, 8, 4)), ((16, 8, 4), (4, 4, 16)),
         ((8, 4), (4, 8, 8)), ((16, 4), (16, 4, 16))]


@pytest.mark.parametrize("kv_bits,codes", MODES,
                         ids=["int4", "mixed", "mixed-4-16", "mixed-8-4",
                              "mixed-16-4"])
def test_update_append_read_exact(kv_bits, codes):
    """Right-padded prefill (``new_length``), a masked append and ``read``:
    every raw tensor and the dequantized K/V equal the jitted reference's."""
    k, v, k1, v1 = _inputs(2)
    lens = jnp.asarray([7, 3, 5], jnp.int32)
    active = jnp.asarray([True, False, True])

    def jrun(k, v, k1, v1):
        c = jlayers.KVCache.create(B, S, KVH, DH, kv_bits=kv_bits)
        if codes is not None:
            c = dataclasses.replace(c, kv_bits=jnp.asarray(codes, jnp.int32))
        c = c.update(k, v, 0, new_length=lens).append(k1, v1, active=active)
        return c, c.read(jnp.bfloat16), c.read(jnp.float32)

    jc, jb, jf = jax.jit(jrun)(k, v, k1, v1)
    tc = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=kv_bits, device="cpu")
    if codes is not None:
        tc.kv_bits.copy_(torch.tensor(codes, dtype=torch.int32))
        assert tc.modes == jc.modes
    tc.update(_cv(k), _cv(v), 0, new_length=_cv(lens))
    tc.append(_cv(k1), _cv(v1), active=_cv(active))
    _assert_cache_equal(jc, tc)
    for want, got in zip(jb + jf, tc.read(torch.bfloat16) +
                         tc.read(torch.float32)):
        np.testing.assert_array_equal(_ref(want), _np(got))


def _jarena(k, v, codes):
    """A reference mixed arena of three slots at ``codes``, prefilled."""
    c = jlayers.KVCache.create(B, S, KVH, DH, kv_bits=(16, 8, 4))
    c = dataclasses.replace(c, kv_bits=codes)
    return c.update(k, v, 0, new_length=jnp.asarray([7, 4, 6], jnp.int32))


def _stack(c):
    """A reference cache as a one-period arena leaf ([1, B, ...])."""
    return {"pos0": jax.tree.map(lambda a: a[None], c)}


def _unstack(arena):
    return jax.tree.map(lambda a: a[0], arena["pos0"])


@jax.jit
def _jmigrate(k, v, codes, slot, code):
    """One trace for every (slot, from, to): the reference's jitted
    ``migrate_kv_tier`` on a one-period arena."""
    arena = _stack(_jarena(k, v, codes))
    return _unstack(arena), _unstack(jslots.migrate_kv_tier(arena, slot,
                                                            code))


@pytest.mark.parametrize("src,dst", list(itertools.product((16, 8, 4),
                                                           repeat=2)))
def test_requantize_every_pair(src, dst):
    """Slot 1 of a mixed arena moves from ``src`` to ``dst``
    (``slots.migrate_kv_tier``): the arena equals the jitted reference's,
    the migrated lanes equal ``requantize`` on a copy of the slot, and the
    other slots and every length are untouched, byte for byte."""
    k, v, _, _ = _inputs(3)
    codes = jnp.asarray([8, src, 4], jnp.int32)
    jbefore, jafter = _jmigrate(k, v, codes, jnp.int32(1), jnp.int32(dst))
    arena = [{"pos0": tlayers.KVCache.create(B, S, KVH, DH, kv_bits=(16, 8, 4),
                                             device="cpu")}]
    c = arena[0]["pos0"]
    c.kv_bits.copy_(_cv(codes))
    c.update(_cv(k), _cv(v), 0, new_length=torch.tensor([7, 4, 6]))
    _assert_cache_equal(jbefore, c)
    before = [t.clone() for t in c.tensors()]
    copy = tlayers.KVCache(*[t.clone() for t in c.slot(1).tensors()],
                           modes=c.modes)
    tslots.migrate_kv_tier(arena, 1, dst)
    _assert_cache_equal(jafter, c)
    copy.requantize(dst)
    for got, want in zip(c.slot(1).tensors(), copy.tensors()):
        assert torch.equal(got, want)
    for got, old in zip(c.tensors(), before):
        if got.ndim > 1:                   # lanes and scales
            assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
    assert torch.equal(c.length, before[4])
    assert c.kv_bits.tolist() == [8, dst, 4]


@jax.jit
def _jslot_reuse(arena, slot, code, k, v, length, k1, v1, active):
    """The reference engine's admission of one slot (reset, tier code,
    prefill through a slot view, write back), then one masked append."""
    sub = jax.tree.map(jnp.zeros_like, jslots.slot_view(arena, slot))
    sub = jslots.fill_kv_tier(sub, code)
    sub = _stack(_unstack(sub).update(k, v, 0, new_length=length))
    arena = jslots.slot_write(arena, sub, slot)
    return _stack(_unstack(arena).append(k1, v1, active=active))


def test_slot_reuse_across_kv_tiers_arena_exact():
    """One slot admitted at bf16, then int4, then int8 (its neighbours
    decoding meanwhile): after each admission and append the port's arena
    (reset, ``fill_kv_tier``, prefill through a slot view) equals the
    reference's, raw lanes, scales, lengths and tier codes."""
    jarena = _stack(jax.tree.map(jnp.zeros_like, jlayers.KVCache.create(
        B, S, KVH, DH, kv_bits=(16, 8, 4))))
    arena = [{"pos0": tlayers.KVCache.create(B, S, KVH, DH, kv_bits=(16, 8, 4),
                                             device="cpu")}]
    for t in arena[0]["pos0"].tensors():
        t.zero_()
    _assert_cache_equal(_unstack(jarena), arena[0]["pos0"])
    plan = [(0, 16, 5), (1, 8, 3), (2, 4, 6), (1, 4, 4), (1, 8, 2),
            (0, 4, 7)]
    for i, (slot, code, plen) in enumerate(plan):
        k, v, k1, v1 = _inputs(10 + i, s_new=8)
        length = jnp.asarray([plen], jnp.int32)
        active = jnp.asarray([True, i % 2 == 0, True])
        jarena = _jslot_reuse(jarena, jnp.int32(slot), jnp.int32(code),
                              k[:1], v[:1], length, k1, v1, active)
        tslots.slot_reset(arena, slot)
        sub = tslots.slot_view(arena, slot)
        tslots.fill_kv_tier(sub, code)
        sub[0]["pos0"].update(_cv(k[:1]), _cv(v[:1]), 0,
                              new_length=_cv(length))
        arena[0]["pos0"].append(_cv(k1), _cv(v1), active=_cv(active))
        _assert_cache_equal(_unstack(jarena), arena[0]["pos0"])


def test_decode_attention_on_a_mixed_arena():
    """``decode_attention`` reads a mixed arena through ``read``: equal to
    the jitted reference's, and per slot to a homogeneous cache's."""
    rng = np.random.default_rng(5)
    k, v, _, _ = _inputs(4)
    q = jnp.asarray(rng.normal(size=(B, 1, 4, DH)), jnp.bfloat16)
    codes = jnp.asarray([16, 8, 4], jnp.int32)
    jc = _jarena(k, v, codes)
    want = jax.jit(jlayers.decode_attention)(q, jc)
    tc = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=(16, 8, 4),
                                device="cpu")
    tc.kv_bits.copy_(_cv(codes))
    tc.update(_cv(k), _cv(v), 0, new_length=torch.tensor([7, 4, 6]))
    got = tlayers.decode_attention(_cv(q), tc)
    np.testing.assert_array_equal(_ref(want), _np(got))
    for slot, mode in enumerate((None, 8, 4)):
        homo = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=mode,
                                      device="cpu")
        homo.update(_cv(k), _cv(v), 0, new_length=torch.tensor([7, 4, 6]))
        assert torch.equal(tlayers.decode_attention(_cv(q), homo)[slot],
                           got[slot])


def test_mixed_kv_arena_matches_homogeneous_modes():
    """Each slot of the mixed arena stores the bytes of the homogeneous
    cache at its code (zero-padded lanes) and reads back exactly what that
    cache reads, after a prefill and a masked append."""
    k, v, k1, v1 = _inputs(6)
    slot_modes = [None, 8, 4]
    active = torch.tensor([True, False, True])
    mixed = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=(16, 8, 4),
                                   device="cpu")
    mixed.kv_bits.copy_(torch.tensor([16, 8, 4], dtype=torch.int32))
    mixed.update(_cv(k), _cv(v), 0, new_length=torch.tensor([5, 5, 5]))
    mixed.append(_cv(k1), _cv(v1), active=active)
    km, vm = mixed.read()
    for i, mode in enumerate(slot_modes):
        ref = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=mode,
                                     device="cpu")
        ref.update(_cv(k), _cv(v), 0, new_length=torch.tensor([5, 5, 5]))
        ref.append(_cv(k1), _cv(v1), active=active)
        kr, vr = ref.read()
        assert torch.equal(km[i], kr[i]) and torch.equal(vm[i], vr[i])
        assert torch.equal(mixed.length, ref.length)
        lane = ref.k[i].contiguous().view(torch.uint8)
        assert torch.equal(mixed.k[i, ..., :lane.shape[-1]], lane)
        assert not mixed.k[i, ..., lane.shape[-1]:].any()
        if mode is not None:
            assert torch.equal(mixed.k_scale[i], ref.k_scale[i])


def test_kv_cache_create_validation():
    with pytest.raises(ValueError, match="kv_bits"):
        tlayers.KVCache.create(1, 4, 2, 16, kv_bits=3)
    with pytest.raises(ValueError, match="even head_dim"):
        tlayers.KVCache.create(1, 4, 2, 15, kv_bits=4)
    with pytest.raises(ValueError, match="even head_dim"):
        tlayers.KVCache.create(1, 4, 2, 15, kv_bits=(16, 8))
    with pytest.raises(ValueError, match="tiers must be from"):
        tlayers.KVCache.create(1, 4, 2, 16, kv_bits=(16, 5))
    c = tlayers.KVCache.create(2, 4, 2, 16, kv_bits=(4, 16, 8), device="cpu")
    assert c.mixed and c.modes == (16, 8, 4) and not c.packed4
    assert c.k.shape[-1] == 32 and c.head_dim == 16
    assert c.kv_bits.tolist() == [16, 16]
    c4 = tlayers.KVCache.create(2, 4, 2, 16, kv_bits=4, device="cpu")
    assert c4.packed4 and c4.k.shape[-1] == 8 and c4.head_dim == 16
    assert tlayers.KVCache.create(2, 4, 2, 16, kv_bits=(8, 4),
                                  device="cpu").head_dim == 16
    with pytest.raises(ValueError, match="needs the mixed"):
        c4.requantize(8)


# ------------------------------------------- the decode-attention kernel
def test_decode_attention_on_the_cpu_takes_the_plain_path():
    """A CPU tensor takes the plain version (``read`` + ``_decode_core``)
    in every storage mode and launches nothing."""
    from repro_torch.kernels import _build
    gen = torch.Generator().manual_seed(8)
    q = torch.randn((B, 1, 4, DH), generator=gen).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    for mode in (None, 8, 4, (16, 8, 4)):
        tc = tlayers.KVCache.create(B, S, KVH, DH, kv_bits=mode, device="cpu")
        if tc.mixed:
            tc.kv_bits.copy_(torch.tensor([16, 8, 4]))
        tc.update(*(torch.randn((B, S, KVH, DH), generator=gen)
                    .to(torch.bfloat16) for _ in range(2)), 0,
                  new_length=torch.tensor([0, 5, S], dtype=torch.int32))
        k, v = tc.read(q.dtype)
        assert torch.equal(tlayers.decode_attention(q, tc),
                           tlayers._decode_core(q, k, v, length=tc.length))
    assert _build.LAUNCHES == before


def _off_layout(case: str):
    """(q, cache) off the kernel's layout in one way, and the words its
    message names."""
    gen = torch.Generator().manual_seed(9)
    dh = 64
    q = torch.randn((2, 1, 4, dh), generator=gen).to(torch.bfloat16)
    mode = {"int8_scale": 8, "kv_bits": (16, 8)}.get(case)
    cache = tlayers.KVCache.create(2, 8, 2, dh, kv_bits=mode, device="cpu")
    if case == "q_dtype":
        return q.float(), cache, "q must be bf16"
    if case == "q_rows":
        return q.expand(2, 3, 4, dh), cache, "q must be bf16"
    if case == "q_strided":
        return q.transpose(2, 3).contiguous().transpose(2, 3), cache, \
            "Dh contiguous"
    if case == "heads":
        return q[:, :, :3], cache, "multiple of KVH"
    if case == "head_dim":
        q48 = q[..., :48].contiguous()
        c48 = tlayers.KVCache.create(2, 8, 2, 48, device="cpu")
        return q48, c48, "head size 48"
    if case == "f32_cache":
        return q, tlayers.KVCache.create(2, 8, 2, dh, dtype=torch.float32,
                                         device="cpu"), "no storage code"
    if case == "lanes":
        cache.k = cache.k[..., :dh // 2]
        cache.v = cache.v[..., :dh // 2]
        return q, cache, "cannot hold a head"
    if case == "misaligned":
        flat = torch.zeros(cache.k.numel() + 1, dtype=torch.bfloat16)
        cache.k = flat[1:].view(cache.k.shape)
        return q, cache, "16-byte boundaries"
    if case == "lane_stride":
        cache.v = cache.v.transpose(2, 3).contiguous().transpose(2, 3)
        return q, cache, "contiguous lanes"
    if case == "int8_scale":
        cache.k_scale = cache.k_scale.float()
        return q, cache, "k_scale must be bf16"
    if case == "length":
        cache.length = cache.length.long()
        return q, cache, "length must be"
    if case == "kv_bits":
        cache.kv_bits = cache.kv_bits[:1]
        return q, cache, "kv_bits must be"
    assert case == "cpu"
    return q, cache, "expected cuda"


@pytest.mark.parametrize("case", [
    "q_dtype", "q_rows", "q_strided", "heads", "head_dim", "f32_cache",
    "lanes", "misaligned", "lane_stride", "int8_scale", "length", "kv_bits",
    "cpu"])
def test_decode_attention_kernel_refuses_what_it_does_not_take(case):
    """The kernel's wrapper raises, naming the fault, for every operand off
    its layout, and for a tensor that is not on a card (the layer takes
    the plain version there and never calls it)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    q, cache, words = _off_layout(case)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=words):
        decode_attention(q, cache)
    assert _build.LAUNCHES == before
