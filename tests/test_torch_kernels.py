"""repro_torch kernel wrappers and ops held EXACTLY against the JAX
package: the wrappers take their plain versions for CPU tensors, and each
is compared with the reference's Pallas kernel run in interpret mode (as
the reference's own tests run it) and with its jnp oracle.  Codes, scales,
int32 accumulators and bf16 output bits must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decompose as jdec
from repro.core.policy import LayerPrecision as JLP
from repro.kernels import act_quant as jaq
from repro.kernels import bitserial_matmul as jbsm
from repro.kernels import grouped_matmul as jgmm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import to_torch
from repro_torch.core import decompose as tdec
from repro_torch.core.policy import LayerPrecision as TLP
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as taq
from repro_torch.kernels import bitserial_matmul as tbsm
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


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


def _cpu(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_act_quant_matches_reference_and_pallas(bits, signed):
    x = (np.random.default_rng(bits).normal(size=(16, 96)) * 3).astype(
        np.float32)
    before = dict(_build.LAUNCHES)
    qt, st = taq.act_quant(torch.from_numpy(x), bits=bits, signed=signed)
    assert _build.LAUNCHES == before          # CPU tensors never launch
    qr, sr = jref.act_quant_ref(jnp.asarray(x), bits=bits, signed=signed)
    _eq(qr, qt)
    _eq(sr, st)
    qp, sp = jaq.act_quant(jnp.asarray(x), bits=bits, signed=signed, bm=8,
                           interpret=True)
    _eq(qp, qt)
    _eq(sp, st)


def test_act_quant_rows_matches_reference_and_pallas():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(16, 96)) * 3).astype(np.float32)
    qmax = np.asarray([[127.0], [7.0], [1.0], [31.0]] * 4, np.float32)
    qt, st = taq.act_quant_rows(torch.from_numpy(x), torch.from_numpy(qmax))
    qr, sr = jref.act_quant_rows_ref(jnp.asarray(x), jnp.asarray(qmax))
    _eq(qr, qt)
    _eq(sr, st)
    qp, sp = jaq.act_quant_rows(jnp.asarray(x), jnp.asarray(qmax), bm=8,
                                interpret=True)
    _eq(qp, qt)
    _eq(sp, st)
    # Row-wise identical to the one-width kernel at that row's width.
    for r, bits in ((0, 8), (1, 4), (2, 2), (3, 6)):
        q1, s1 = taq.act_quant(torch.from_numpy(x[r::4].copy()), bits=bits)
        assert torch.equal(q1, qt[r::4]) and torch.equal(s1, st[r::4])


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("msb_first", [True, False])
def test_bitserial_matmul_matches_pallas(p, msb_first):
    rng = np.random.default_rng(10 * p + msb_first)
    x = rng.integers(-128, 128, size=(8, 256)).astype(np.int8)
    q8 = rng.integers(-128, 128, size=(256, 128))
    planes = np.asarray(jdec.decompose_superplanes(jnp.asarray(q8)))[:p].copy()
    if not msb_first:
        planes = planes[::-1].copy()
    shifts = (tdec.prefix_shifts(p) if msb_first
              else tuple(2 * c for c in range(p)))
    got = tbsm.bitserial_matmul(torch.from_numpy(x), torch.from_numpy(planes),
                                shifts)
    want = jbsm.bitserial_matmul(jnp.asarray(x), jnp.asarray(planes),
                                 w_bits=2 * p, msb_first=msb_first, bm=8,
                                 interpret=True)
    _eq(want, got)


def test_grouped_dequant_matmul_matches_pallas():
    rng = np.random.default_rng(5)
    m, k, n = 8, 256, 128
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    planes = np.array(jdec.decompose_superplanes(
        jnp.asarray(rng.integers(-128, 128, size=(k, n)))))
    layout = ((3, 4), (3, 2), (2, 1))
    mult = jdec.prefix_multipliers(layout)
    xs = (rng.random((m, 1)) * 1e-2 + 1e-4).astype(np.float32)
    base = (rng.random((1, n)) * 1e-2 + 1e-5).astype(np.float32)
    ws_groups = np.concatenate([base, base * 16, base * 64])
    row_group = np.repeat(np.arange(3, dtype=np.int32), [3, 3, 2])
    got = tgmm.grouped_dequant_matmul(
        torch.from_numpy(x), torch.from_numpy(planes), torch.from_numpy(mult),
        torch.from_numpy(xs), torch.from_numpy(ws_groups),
        torch.from_numpy(row_group))
    want = jgmm.grouped_dequant_matmul(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(mult),
        jnp.asarray(xs), jnp.asarray(ws_groups[row_group]), nplanes=4,
        bm=8, interpret=True)
    _eq(want, got)


@pytest.mark.parametrize("signed", [True, False])
def test_prepared_stores_equal(signed):
    w = np.random.default_rng(2).normal(size=(64, 48)).astype(np.float32)
    js = jops.prepare_superplane(jnp.asarray(w), signed=signed)
    ts = tops.prepare_superplane(torch.from_numpy(w), signed=signed)
    _eq(js.planes, ts.planes)
    _eq(js.scale, ts.scale)
    for bits in (2, 3, 4, 5, 6, 7, 8):
        jw = jops.prepare_weight(jnp.asarray(w), JLP(bits, 8, w_signed=signed,
                                                     backend="decomposed"))
        tw = tops.prepare_weight(torch.from_numpy(w), TLP(
            bits, 8, w_signed=signed, backend="decomposed"))
        _eq(jw.planes, tw.planes)
        _eq(jw.scale, tw.scale)


GROUPS = ((3, 8), (2, 4), (2, 2))


@pytest.mark.parametrize("tbackend,jbackend", [("cuda", "pallas"),
                                               ("decomposed", "decomposed")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_decode_linear_bits_equal(tbackend, jbackend, dtype):
    """The fused mixed-tier projection: same bf16/f32 output bits as the
    reference's, with and without a slot permutation."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(7, 1, 64)), getattr(jnp, dtype))
    jqw = jops.prepare_superplane(jnp.asarray(w))
    tqw = tops.prepare_superplane(torch.from_numpy(w))
    jg = tuple((n, JLP(b, b, backend=jbackend)) for n, b in GROUPS)
    tg = tuple((n, TLP(b, b, backend=tbackend)) for n, b in GROUPS)
    perm = np.asarray([6, 2, 0, 5, 3, 1, 4])
    for p in (None, perm):
        want = jops.fused_decode_linear(x, jqw, jg,
                                        None if p is None else jnp.asarray(p))
        got = tops.fused_decode_linear(_cpu(x), tqw, tg,
                                       None if p is None else torch.from_numpy(p))
        _eq(want, got)
        # The per-group reference path is bit-identical to the fused one.
        per_group = tops.matmul(_cpu(x), None, tg[0][1], qw=tqw, row_groups=tg,
                                perm=None if p is None else torch.from_numpy(p),
                                fused=False)
        assert torch.equal(per_group, got)


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_decomposed_quantizes_through_the_plain_versions(backend,
                                                         monkeypatch):
    """``cuda`` quantizes a mixed-tier batch through the act_quant_rows
    wrapper, once for q/k/v alike; ``decomposed`` never calls a wrapper,
    so on the card it launches no kernel, and its bits are the same."""
    calls = []
    for name in ("act_quant", "act_quant_rows"):
        fn = getattr(taq, name)
        monkeypatch.setattr(taq, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    rng = np.random.default_rng(9)
    qw = tops.prepare_superplane(torch.from_numpy(
        rng.normal(size=(64, 48)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(7, 1, 64)).astype(np.float32))
    tg = tuple((n, TLP(b, b, backend=backend)) for n, b in GROUPS)
    acts = {}
    ys = [tops.matmul(x, None, tg[0][1], qw=qw, row_groups=tg, act_quants=acts)
          for _ in range(3)]
    assert calls == (["act_quant_rows"] if backend == "cuda" else [])
    want = tops.fused_decode_linear(
        x, qw, tuple((n, g.with_backend("cuda")) for n, g in tg), None)
    assert all(torch.equal(y, want) for y in ys)


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_integer_matmul_matches_reference(backend, bits):
    """Homogeneous path (prefill / one-tier steps): act-quant + plane-prefix
    GEMM + dequant, from a superplane store and from fixed planes."""
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(64, 40)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)), jnp.bfloat16)
    jb = "pallas" if backend == "cuda" else backend
    jp, tp = JLP(bits, bits, backend=jb), TLP(bits, bits, backend=backend)
    stores = ((jops.prepare_superplane(jnp.asarray(w)),
               tops.prepare_superplane(torch.from_numpy(w))),
              (jops.prepare_weight(jnp.asarray(w), jp),
               tops.prepare_weight(torch.from_numpy(w), tp)))
    for jqw, tqw in stores:
        _eq(jops.matmul(x, None, jp, qw=jqw),
            tops.matmul(_cpu(x), None, tp, qw=tqw))


def test_quantize_activations_grouped_shares_codes():
    """One distinct a-config quantizes once; mixed widths run ONE per-row
    pass whose rows equal the per-width quantization."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(6, 1, 32)).astype(np.float32))
    g = ((2, TLP(8, 8, backend="cuda")), (2, TLP(4, 4, backend="cuda")),
         (2, TLP(2, 2, backend="cuda")))
    perm = torch.tensor([4, 0, 2, 5, 1, 3])
    acts = {}
    q, s = tops.quantize_activations_grouped(x, g, perm, act_quants=acts)
    q2, _ = tops.quantize_activations_grouped(x, g, perm, act_quants=acts)
    assert q2 is q and len(acts) == 1
    for i, (row, bits) in enumerate(zip(perm.tolist(), [8, 8, 4, 4, 2, 2])):
        qr, sr = tops.quantize_activations(x[row], bits)
        assert torch.equal(q[i], qr) and torch.equal(s[i], sr)


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        taq.act_quant(x)
    with pytest.raises(ValueError, match="qmax"):
        taq.act_quant_rows(x.float(), torch.ones((3, 1)))
    with pytest.raises(ValueError, match="shapes"):
        tbsm.bitserial_matmul(torch.zeros((2, 8), dtype=torch.int8),
                              torch.zeros((1, 9, 4), dtype=torch.int8), (0,))
    with pytest.raises(ValueError, match="planes with shifts"):
        tbsm.bitserial_matmul(torch.zeros((2, 8), dtype=torch.int8),
                              torch.zeros((2, 8, 4), dtype=torch.int8), (0,))
    with pytest.raises(ValueError, match="cuda"):
        tbsm.bitserial_matmul(torch.zeros((2, 8), dtype=torch.int8,
                                          device="meta"),
                              torch.zeros((1, 8, 4), dtype=torch.int8,
                                          device="meta"), (0,))
    with pytest.raises(ValueError, match="uint8"):
        tbsm.packed_bitserial_matmul(torch.zeros((2, 8), dtype=torch.int8),
                                     torch.zeros((8, 4), dtype=torch.int8),
                                     w_bits=8)
    with pytest.raises(ValueError, match="eff_bits 8"):
        tbsm.packed_bitserial_matmul(torch.zeros((2, 8), dtype=torch.int8),
                                     torch.zeros((8, 4), dtype=torch.uint8),
                                     w_bits=4, eff_bits=8)
    with pytest.raises(ValueError, match="packed=False takes planes"):
        tgmm.grouped_matmul(torch.zeros((2, 8), dtype=torch.int8),
                            torch.zeros((8, 4), dtype=torch.uint8),
                            torch.ones((2, 1), dtype=torch.int32))


def test_plain_versions_on_edge_shapes():
    """Ragged / empty shapes through the plain versions the kernels are
    held against on the card."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-128, 128, size=(5, 41)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(-128, 128, size=(41, 13)))
    planes = tdec.decompose_superplanes(q8)
    w = tdec.recompose_weights(planes.flip(0), 8)
    np.testing.assert_array_equal(
        tref.bitserial_matmul_ref(x, planes, tdec.prefix_shifts(4)).numpy(),
        x.numpy().astype(np.int64) @ w.numpy())
    empty = tref.act_quant_ref(torch.zeros((0, 7)))
    assert empty[0].shape == (0, 7) and empty[1].shape == (0, 1)
