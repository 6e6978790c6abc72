"""The byte-packed store (``--packed``: one uint8 per weight, plane c at bits
2c) in repro_torch, held EXACTLY against the JAX package.

* ``pack_planes`` / ``unpack_planes`` and the packed stores of
  ``prepare_weight`` (odd widths keep planes), ``prepare_superplane`` and
  ``truncate_weight`` are byte-equal to the reference's, through
  ``convert``;
* the plain versions of ``packed_bitserial_matmul``, ``grouped_matmul`` and
  the packed mode of ``grouped_dequant_matmul`` equal the reference's
  Pallas kernels run with ``interpret=True``;
* ``ops`` on a packed store equals the int8-plane store and the reference;
* a reduced qwen3-8b mixed-tier ``ServeEngine(packed=True)`` gives the
  reference ``ServeEngine(packed=True)``'s greedy streams (reference run in
  a subprocess, see _torch_reference.py).

Tolerance 0 everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (ENGINE_KW, TIERS, reference_streams,
                              reference_weights, request_specs, to_requests)
from repro.core import decompose as jdec
from repro.core.policy import LayerPrecision as JLP
from repro.core.policy import uniform_policy as juniform_policy
from repro.kernels import bitserial_matmul as jbsm
from repro.kernels import grouped_matmul as jgmm
from repro.kernels import ops as jops
from repro.serve.engine import prepare_params as jprepare
from repro_torch.configs import reduced_config
from repro_torch.convert import convert_params
from repro_torch.core import decompose as tdec
from repro_torch.core.policy import LayerPrecision as TLP
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.kernels import bitserial_matmul as tbsm
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine, prepare_params

EVEN = (2, 4, 6, 8)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(a, t: torch.Tensor) -> None:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
        b = t.view(torch.int16).numpy().view(np.uint16)
    else:
        b = t.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                      b.shape, b.dtype)
    np.testing.assert_array_equal(a, b)


def _converted(jqw) -> tops.QuantizedWeight:
    """A reference QuantizedWeight through the port's converter."""
    return convert_params({"w": jax.tree.map(np.asarray, jqw)},
                          device="cpu")["w"]


def _same_store(a: tops.QuantizedWeight, b: tops.QuantizedWeight) -> None:
    assert (a.planes is None) == (b.planes is None)
    assert (a.packed is None) == (b.packed is None)
    for x, y in ((a.planes, b.planes), (a.packed, b.packed),
                 (a.scale, b.scale)):
        assert x is None or (x.dtype == y.dtype and torch.equal(x, y))
    assert (a.w_bits, a.signed, a.msb_first) == (b.w_bits, b.signed,
                                                 b.msb_first)


# ------------------------------------------------------------------- stores
@pytest.mark.parametrize("w_bits", EVEN)
@pytest.mark.parametrize("signed", [True, False])
def test_pack_unpack_equal_reference(w_bits, signed):
    rng = np.random.default_rng(w_bits + 10 * signed)
    lo, hi = jdec.weight_range(w_bits, signed)
    planes = jdec.decompose_weights(
        jnp.asarray(rng.integers(lo, hi + 1, size=(40, 24))), w_bits,
        signed=signed)
    jp = jops.pack_planes(planes, w_bits)
    tp = tops.pack_planes(_t(planes), w_bits)
    _eq(jp, tp)
    _eq(jops.unpack_planes(jp, w_bits, signed), tops.unpack_planes(tp, w_bits,
                                                                   signed))
    _eq(planes, tops.unpack_planes(tp, w_bits, signed))


@pytest.mark.parametrize("signed", [True, False])
def test_prepared_packed_stores_equal_reference(signed):
    w = np.random.default_rng(2).normal(size=(64, 48)).astype(np.float32)
    for bits in range(2, 9):
        jprec = JLP(bits, 8, w_signed=signed, backend="decomposed")
        tprec = TLP(bits, 8, w_signed=signed, backend="decomposed")
        mine = tops.prepare_weight(_t(w), tprec, packed=True)
        _same_store(mine, _converted(jops.prepare_weight(
            jnp.asarray(w), jprec, packed=True)))
        assert (mine.packed is None) == (bits % 2 == 1)   # odd keeps planes
        assert torch.equal(mine.get_planes(),
                           tops.prepare_weight(_t(w), tprec).planes)
    stores = {packed: tops.prepare_superplane(_t(w), signed=signed,
                                              packed=packed)
              for packed in (False, True)}
    _same_store(stores[True], _converted(jops.prepare_superplane(
        jnp.asarray(w), signed=signed, packed=True)))
    assert torch.equal(stores[True].get_planes(), stores[False].planes)
    for eff in EVEN:
        fresh = {packed: tops.prepare_weight(
            _t(w), TLP(eff, 8, w_signed=signed, backend="decomposed"),
            packed=packed) for packed in (False, True)}
        for packed, store in stores.items():
            tr = tops.truncate_weight(store, eff)
            _same_store(tr, fresh[packed])
            _same_store(tr, _converted(jops.truncate_weight(
                jops.prepare_superplane(jnp.asarray(w), signed=signed,
                                        packed=packed), eff)))


@pytest.mark.parametrize("superplane", [True, False])
def test_convert_packed_params(superplane):
    """The reference's period-stacked packed store, converted, equals the
    port's prepare_params(packed=True) on the converted float weights."""
    jm, jp, _, tp = reference_weights()
    jprep = jprepare(jp, juniform_policy(4, 8, backend="decomposed"), jm,
                     packed=True, superplane=superplane)[0]
    want = convert_params(jax.tree.map(np.asarray, jprep), device="cpu")
    got, paths = prepare_params(tp, uniform_policy(4, 8, backend="decomposed"),
                                LM(reduced_config("qwen3-8b")), packed=True,
                                superplane=superplane)
    assert len(paths) == 7 * jm.cfg.n_periods + 1
    assert len(got["layers"]) == len(want["layers"]) == jm.cfg.n_periods
    n = 0
    for mine, ref in zip(got["layers"], want["layers"]):
        for blk in ("attn", "mlp"):
            for proj, leaf in mine["pos0"][blk].items():
                if isinstance(leaf.get("w"), tops.QuantizedWeight):
                    _same_store(leaf["w"], ref["pos0"][blk][proj]["w"])
                    assert leaf["w"].packed is not None
                    n += 1
    assert n == 7 * jm.cfg.n_periods
    _same_store(got["lm_head"]["w"], want["lm_head"]["w"])


# ----------------------------------------------------- kernels' plain versions
@pytest.mark.parametrize("w_bits", EVEN)
@pytest.mark.parametrize("signed", [True, False])
def test_packed_bitserial_matmul_equals_pallas(w_bits, signed):
    """Every even effective width of a w_bits store: the plain version ==
    the Pallas kernel (interpret) == x @ (q >> base); from an 8-bit store
    also == the int8-plane prefix GEMM and the decomposed route."""
    rng = np.random.default_rng(w_bits + 10 * signed)
    lo, hi = jdec.weight_range(w_bits, signed)
    q = rng.integers(lo, hi + 1, size=(256, 128))
    packed = jops.pack_planes(jdec.decompose_weights(jnp.asarray(q), w_bits,
                                                     signed=signed), w_bits)
    x = rng.integers(-128, 128, size=(8, 256)).astype(np.int8)
    for eff in range(2, w_bits + 1, 2):
        got = tbsm.packed_bitserial_matmul(_t(x), _t(packed), w_bits=w_bits,
                                           eff_bits=eff, signed=signed)
        _eq(jbsm.packed_bitserial_matmul(
            jnp.asarray(x), packed, w_bits=w_bits, eff_bits=eff,
            signed=signed, bm=8, interpret=True), got)
        np.testing.assert_array_equal(
            got.numpy(), x.astype(np.int64) @ (q >> (w_bits - eff)))
        if w_bits == 8:
            p = eff // 2
            msb = tdec.decompose_superplanes(_t(q), signed=signed)[:p]
            assert torch.equal(got, tref.bitserial_matmul_ref(
                _t(x), msb, tdec.prefix_shifts(p)))
            assert torch.equal(got, tdec.decomposed_matmul(
                _t(x), tops.unpack_planes(_t(packed), 8, signed)[4 - p:],
                eff))


LAYOUT = ((3, 4), (3, 2), (2, 1))


@pytest.mark.parametrize("signed", [True, False])
def test_grouped_kernels_equal_pallas(signed):
    """grouped_matmul on both layouts and the packed mode of
    grouped_dequant_matmul == the reference's Pallas kernels."""
    rng = np.random.default_rng(5 + signed)
    m, k, n = 8, 256, 128
    lo, hi = jdec.weight_range(8, signed)
    planes = jdec.decompose_superplanes(
        jnp.asarray(rng.integers(lo, hi + 1, size=(k, n))), signed=signed)
    packed = jops.pack_planes(planes[::-1], 8)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    mult = jdec.prefix_multipliers(LAYOUT)
    lay = dict(signed=signed, bm=8, interpret=True)
    for w, packed_mode in ((planes, False), (packed, True)):
        _eq(jgmm.grouped_matmul(jnp.asarray(x), w, jnp.asarray(mult),
                                nplanes=4, packed=packed_mode, **lay),
            tgmm.grouped_matmul(_t(x), _t(w), _t(mult), packed=packed_mode,
                                signed=signed))
    xs = (rng.random((m, 1)) * 1e-2 + 1e-4).astype(np.float32)
    base = (rng.random((1, n)) * 1e-2 + 1e-5).astype(np.float32)
    ws = np.concatenate([base, base * 16, base * 64])
    row_group = np.repeat(np.arange(3, dtype=np.int32), [r for r, _ in LAYOUT])
    _eq(jgmm.grouped_dequant_matmul(
        jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(xs),
        jnp.asarray(ws[row_group]), nplanes=4, packed=True, **lay),
        tgmm.grouped_dequant_matmul(_t(x), _t(packed), _t(mult), _t(xs),
                                    _t(ws), _t(row_group), packed=True,
                                    signed=signed))
    # A fixed 4-bit store has two fields; its top field carries the sign.
    w4 = jops.pack_planes(jdec.decompose_weights(
        jnp.asarray(rng.integers(-8, 8, size=(k, n))) if signed else
        jnp.asarray(rng.integers(0, 16, size=(k, n))), 4, signed=signed), 4)
    mult4 = jdec.prefix_multipliers(((m, 2),))
    _eq(jgmm.grouped_matmul(jnp.asarray(x), w4, jnp.asarray(mult4), nplanes=2,
                            packed=True, store_planes=2, **lay),
        tgmm.grouped_matmul(_t(x), _t(w4), _t(mult4), packed=True,
                            store_planes=2, signed=signed))


# ------------------------------------------------------------------ dispatch
GROUPS = ((3, 8), (2, 4), (2, 2))


@pytest.mark.parametrize("tbackend,jbackend", [("cuda", "pallas"),
                                               ("decomposed", "decomposed")])
def test_ops_on_packed_store_equal_planes_and_reference(tbackend, jbackend):
    """matmul (prefill/one-tier), fused_decode_linear (mixed tiers) and the
    kernel-level bitserial_matmul_planes(row_groups=) on a packed store ==
    the int8-plane store == the reference on its packed store."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(7, 1, 64)), jnp.bfloat16)
    tx = convert_params({"x": np.asarray(x)}, device="cpu")["x"]
    jqw = jops.prepare_superplane(jnp.asarray(w), packed=True)
    tqw = {p: tops.prepare_superplane(_t(w), packed=p) for p in (False, True)}
    for bits in EVEN:
        jp, tp = JLP(bits, bits, backend=jbackend), TLP(bits, bits,
                                                        backend=tbackend)
        want = tops.matmul(tx, None, tp, qw=tqw[False])
        _eq(jops.matmul(x, None, jp, qw=jqw), want)
        assert torch.equal(tops.matmul(tx, None, tp, qw=tqw[True]), want)
        fixed = {p: tops.prepare_weight(_t(w), tp, packed=p)
                 for p in (False, True)}
        assert torch.equal(tops.matmul(tx, None, tp, qw=fixed[True]),
                           tops.matmul(tx, None, tp, qw=fixed[False]))
    jg = tuple((r, JLP(b, b, backend=jbackend)) for r, b in GROUPS)
    tg = tuple((r, TLP(b, b, backend=tbackend)) for r, b in GROUPS)
    perm = np.asarray([6, 2, 0, 5, 3, 1, 4])
    for p in (None, perm):
        tperm = None if p is None else torch.from_numpy(p)
        want = tops.fused_decode_linear(tx, tqw[False], tg, tperm)
        _eq(jops.fused_decode_linear(x, jqw, jg,
                                     None if p is None else jnp.asarray(p)),
            want)
        assert torch.equal(tops.fused_decode_linear(tx, tqw[True], tg, tperm),
                           want)
    xq = rng.integers(-128, 128, size=(7, 64)).astype(np.int8)
    want = jops.bitserial_matmul_pallas(jnp.asarray(xq), jqw, row_groups=GROUPS,
                                        bm=8)
    for store in tqw.values():
        _eq(want, tops.bitserial_matmul_planes(_t(xq), store,
                                               row_groups=GROUPS))


# ----------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def packed_reference():
    specs = request_specs()
    streams, checksum = reference_streams(ENGINE_KW, specs, packed=True)
    _, _, mine, params = reference_weights()
    assert mine == checksum
    return params, specs, streams


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_packed_streams_equal_reference_engine(packed_reference, backend,
                                               monkeypatch):
    """ServeEngine(packed=True) prepares the byte store once and serves the
    reference's packed engine's streams; the ``cuda`` backend reaches the
    packed GEMMs' wrappers and never the int8-plane one."""
    params, specs, ref = packed_reference
    calls = []
    for mod, name in ((tbsm, "bitserial_matmul"),
                      (tbsm, "packed_bitserial_matmul"),
                      (tgmm, "grouped_dequant_matmul")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append((_n, kw.get("packed"))) or
                            _f(*a, **kw))
    sched = uniform_schedule(TIERS, backend=backend)
    before = engine_mod.PREPARE_CALLS
    eng = ServeEngine(LM(reduced_config("qwen3-8b")), params,
                      Runtime(policy=sched.policy_for(), schedule=sched),
                      device="cpu", packed=True, **ENGINE_KW)
    assert engine_mod.PREPARE_CALLS == before + 1
    head = eng.params["lm_head"]["w"]
    assert head.planes is None and head.packed.dtype == torch.uint8
    assert eng.run(to_requests(specs)) == ref
    assert engine_mod.PREPARE_CALLS == before + 1
    assert eng.stats.mixed_tier_chunks > 0
    if backend == "cuda":
        assert {n for n, _ in calls} == {"packed_bitserial_matmul",
                                         "grouped_dequant_matmul"}
        assert all(p for n, p in calls if n == "grouped_dequant_matmul")
    else:
        assert calls == []
