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


def _act_rows(rng, m: int, k: int, qmaxes, signed: bool) -> np.ndarray:
    """f32 [m, k] normal rows (x3); every row 4j + 1 on .5 boundaries after
    the divide at its qmax (amax = qmax / 8, scale = 1/8, x / scale =
    n + 1/2), every row 4j + 3 zero (scale = 1e-8 * (1/qmax))."""
    x = (rng.normal(size=(m, k)) * 3).astype(np.float32)
    for r in range(1, m, 4):
        q = qmaxes[r % len(qmaxes)]
        n = rng.integers(-int(q) if signed else 0, int(q), size=k)
        x[r] = (n + 0.5) / 8
        x[r, 0] = (-q if signed else q) / 8
    x[3::4] = 0
    return x


def _on_half(x32, scale) -> bool:
    """Some x / scale lands exactly on n + 1/2 (round-half-even decides)."""
    quot = np.asarray(x32) / np.asarray(scale)
    return bool(np.any(np.abs(quot) % 1 == 0.5))


# Output rows gathered from 12 bf16 rows: a shuffle of 16 with four rows
# taken twice.
PERM = np.random.default_rng(3).permutation(16) % 12


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_act_quant_bf16_rows_by_perm_match_pallas(bits, signed):
    """The port's act_quant reads bf16 rows and gathers them by ``perm``
    itself: equal to the Pallas kernel (interpret mode) on f32(x)[perm]."""
    rng = np.random.default_rng(20 + bits)
    q = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    xj = jnp.asarray(_act_rows(rng, 12, 96, [q], signed), jnp.bfloat16)
    x32 = xj.astype(jnp.float32)
    perm = torch.from_numpy(PERM.astype(np.int32 if signed else np.int64))
    for p, want_x in ((None, x32), (perm, x32[PERM])):
        qt, st = taq.act_quant(_cpu(xj), bits=bits, signed=signed, perm=p)
        qp, sp = jaq.act_quant(want_x, bits=bits, signed=signed, bm=4,
                               interpret=True)
        _eq(qp, qt)
        _eq(sp, st)
        assert _on_half(want_x, sp)


def test_act_quant_rows_bf16_rows_by_perm_match_pallas():
    """act_quant_rows on bf16 rows gathered by ``perm``: equal to the
    Pallas kernel (interpret mode) on f32(x)[perm], per-row qmax."""
    rng = np.random.default_rng(2)
    qm = (127.0, 7.0, 1.0, 31.0)
    xj = jnp.asarray(_act_rows(rng, 16, 96, qm, True)[:12], jnp.bfloat16)
    x32 = xj.astype(jnp.float32)
    for p in (None, PERM):
        rows = 12 if p is None else 16
        qmax = np.asarray([[qm[i % 4]] for i in range(rows)], np.float32)
        want_x = x32 if p is None else x32[p]
        qt, st = taq.act_quant_rows(
            _cpu(xj), torch.from_numpy(qmax),
            perm=None if p is None else torch.from_numpy(p))
        qp, sp = jaq.act_quant_rows(want_x, jnp.asarray(qmax), bm=4,
                                    interpret=True)
        _eq(qp, qt)
        _eq(sp, st)
        if p is None:
            assert _on_half(want_x, sp)


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
    wrapper, once for q/k/v alike, and hands it x itself: no
    ``Tensor.index_select`` and no ``Tensor.to`` on x before the wrapper
    (the kernel gathers the rows and widens bf16 itself).  ``decomposed``
    never calls a wrapper, so on the card it launches no kernel, and its
    bits are the same."""
    calls, on_x, x_storage = [], [], [None]
    for name in ("act_quant", "act_quant_rows"):
        fn = getattr(taq, name)
        monkeypatch.setattr(taq, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    for name in ("index_select", "to"):
        def counted(t, *a, _f=getattr(torch.Tensor, name), _n=name, **kw):
            if t.untyped_storage().data_ptr() == x_storage[0]:
                on_x.append((_n, len(calls)))     # wrapper calls so far
            return _f(t, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    rng = np.random.default_rng(9)
    qw = tops.prepare_superplane(torch.from_numpy(
        rng.normal(size=(64, 48)).astype(np.float32)))
    tg = tuple((n, TLP(b, b, backend=backend)) for n, b in GROUPS)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(7, 1, 64)).astype(
            np.float32)).to(dtype)
        for p in (None, torch.from_numpy(rng.permutation(7))):
            calls.clear()
            on_x.clear()
            x_storage[0] = x.untyped_storage().data_ptr()
            acts = {}
            ys = [tops.matmul(x, None, tg[0][1], qw=qw, row_groups=tg,
                              perm=p, act_quants=acts) for _ in range(3)]
            x_storage[0] = None
            if backend == "cuda":
                assert calls == ["act_quant_rows"]
                assert all(seen == 1 for _, seen in on_x), on_x
            else:
                assert calls == []
            want = tops.fused_decode_linear(
                x, qw, tuple((n, g.with_backend("cuda")) for n, g in tg), p)
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


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("lead", [(7, 1), (7, 2)])
def test_quantize_activations_grouped_bf16_with_perm_matches_reference(
        mixed, lead):
    """A bf16 batch gathered by a slot permutation: codes and scales equal
    the JAX package's (its jnp oracle and its Pallas kernel in interpret
    mode) bit for bit, for mixed activation widths (one per-row-range
    launch) and for one shared width, one or two rows per slot."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(*lead, 64)) * 3, jnp.bfloat16)
    perm = rng.permutation(lead[0])
    widths = [(w, w if mixed else 8) for _, w in GROUPS]
    jg = tuple((n, JLP(w, a, backend="pallas"))
               for (n, _), (w, a) in zip(GROUPS, widths))
    tg = tuple((n, TLP(w, a, backend="cuda"))
               for (n, _), (w, a) in zip(GROUPS, widths))
    got = tops.quantize_activations_grouped(_cpu(x), tg,
                                            torch.from_numpy(perm))
    for use_pallas in (False, True):
        want = jops.quantize_activations_grouped(
            x, jg, jnp.asarray(perm), use_pallas=use_pallas)
        _eq(want[0], got[0])
        _eq(want[1], got[1])


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
    with pytest.raises(ValueError, match="qmax"):     # one per output row
        taq.act_quant_rows(x.float(), torch.ones((4, 1)),
                           perm=torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="perm"):
        taq.act_quant(x.float(), perm=torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="perm"):
        taq.act_quant(x.float(), perm=torch.tensor([[0, 1]]))
    with pytest.raises(ValueError, match="contiguous"):
        taq.act_quant(x.float().T)
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
