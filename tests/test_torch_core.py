"""repro_torch core numerics held EXACTLY against the JAX package:
quantization codes and scales, Table-I planes, superplanes, prefix
multipliers and the plane-decomposed integer products, for every width
2..8, signed and unsigned; plus the port's import hygiene (no jax, nothing
of the JAX package)."""
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decompose as jdec
from repro.core import policy as jpol
from repro.core import quant as jquant
from repro_torch.core import decompose as tdec
from repro_torch.core import policy as tpol
from repro_torch.core import quant as tquant

ROOT = pathlib.Path(__file__).resolve().parents[1]
BITS = list(range(2, 9))


def _eq(a, t: torch.Tensor) -> None:
    a = np.asarray(a)
    b = t.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 512)])
def test_quantize_and_nested_quantize_exact(bits, signed, shape):
    """Codes AND scales bit-equal, including the stacked [3, 64, 512] case
    on which the reciprocal-multiply form of the weight scale differs from
    the reference's IEEE division on some channels."""
    x = np.random.default_rng(bits + 10 * signed).normal(
        size=shape).astype(np.float32)
    jc = jquant.QuantConfig(bits=bits, signed=signed)
    tc = tquant.QuantConfig(bits=bits, signed=signed)
    for jf, tf in ((jquant.quantize, tquant.quantize),
                   (jquant.nested_quantize, tquant.nested_quantize)):
        qj, sj = jf(jnp.asarray(x), jc)
        qt, st = tf(torch.from_numpy(x), tc)
        _eq(qj, qt)
        _eq(sj, st)


def test_weight_scale_divides():
    """The weight scale is max(amax, eps) / qmax, not * (1/qmax)."""
    x = np.random.default_rng(0).normal(size=(3, 64, 512)).astype(np.float32)
    scale = tquant.compute_scale(torch.from_numpy(x),
                                 tquant.QuantConfig(bits=8))
    amax = np.abs(x).max(axis=(0, 1), keepdims=True)
    want = np.maximum(amax, np.float32(1e-8)) / np.float32(127)
    recip = np.maximum(amax, np.float32(1e-8)) * (np.float32(1) / np.float32(127))
    np.testing.assert_array_equal(scale.numpy(), want)
    assert (want != recip).any()    # the two forms really differ here


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
def test_decompose_weights_exact(bits, signed):
    lo, hi = jdec.weight_range(bits, signed)
    w = np.random.default_rng(bits).integers(lo, hi + 1, size=(48, 40))
    pj = jdec.decompose_weights(jnp.asarray(w), bits, signed=signed)
    pt = tdec.decompose_weights(torch.from_numpy(w), bits, signed=signed)
    _eq(pj, pt)
    _eq(jdec.recompose_weights(pj, bits, signed=signed),
        tdec.recompose_weights(pt, bits, signed=signed))
    np.testing.assert_array_equal(
        tdec.recompose_weights(pt, bits, signed=signed).numpy(), w)
    assert tdec.schedule(bits, signed) == jdec.schedule(bits, signed)
    assert tdec.plane_shifts(bits, signed) == jdec.plane_shifts(bits, signed)


@pytest.mark.parametrize("signed", [True, False])
def test_decompose_superplanes_exact(signed):
    lo, hi = jdec.weight_range(8, signed)
    q8 = np.random.default_rng(7).integers(lo, hi + 1, size=(32, 24))
    _eq(jdec.decompose_superplanes(jnp.asarray(q8), signed=signed),
        tdec.decompose_superplanes(torch.from_numpy(q8), signed=signed))


@pytest.mark.parametrize("layout", [((3, 4), (2, 2), (2, 1)), ((4, 3),),
                                    ((1, 1), (5, 4)), ((2, 2), (2, 3))])
def test_prefix_multipliers_exact(layout):
    np.testing.assert_array_equal(jdec.prefix_multipliers(layout),
                                  tdec.prefix_multipliers(layout))
    for p in (1, 2, 3, 4):
        assert tdec.prefix_shifts(p) == jdec.prefix_shifts(p)


@pytest.mark.parametrize("bits", BITS)
def test_decomposed_matmul_exact(bits):
    rng = np.random.default_rng(bits)
    lo, hi = jdec.weight_range(bits, True)
    w = rng.integers(lo, hi + 1, size=(64, 24))
    x = rng.integers(-128, 128, size=(5, 64)).astype(np.int8)
    pj = jdec.decompose_weights(jnp.asarray(w), bits)
    pt = tdec.decompose_weights(torch.from_numpy(w), bits)
    got = tdec.decomposed_matmul(torch.from_numpy(x), pt, bits)
    _eq(jdec.decomposed_matmul(jnp.asarray(x), pj, bits), got)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w)


def test_decomposed_matmul_multipliers_exact():
    rng = np.random.default_rng(3)
    q8 = rng.integers(-128, 128, size=(64, 40))
    x = rng.integers(-128, 128, size=(7, 64)).astype(np.int8)
    mult = jdec.prefix_multipliers(((3, 4), (2, 2), (2, 1)))
    got = tdec.decomposed_matmul_multipliers(
        torch.from_numpy(x), tdec.decompose_superplanes(torch.from_numpy(q8)),
        torch.from_numpy(mult))
    _eq(jdec.decomposed_matmul_multipliers(
        jnp.asarray(x), jdec.decompose_superplanes(jnp.asarray(q8)), mult), got)


@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_truncate_and_nested_scale_exact(bits):
    q = np.random.default_rng(bits).integers(-128, 128, size=(9, 9))
    _eq(jquant.truncate_qint(jnp.asarray(q, jnp.int8), 8, bits),
        tquant.truncate_qint(torch.from_numpy(q).to(torch.int8), 8, bits))
    s = np.random.default_rng(1).random((1, 9)).astype(np.float32)
    _eq(jquant.nested_scale(jnp.asarray(s), 8, bits),
        tquant.nested_scale(torch.from_numpy(s), 8, bits))


def test_dequantize_exact():
    rng = np.random.default_rng(4)
    q = rng.integers(-128, 128, size=(6, 40)).astype(np.int8)
    s = rng.random((1, 40)).astype(np.float32)
    _eq(jquant.dequantize(jnp.asarray(q), jnp.asarray(s)),
        tquant.dequantize(torch.from_numpy(q), torch.from_numpy(s)))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_unsigned_activations_exact(bits):
    """Post-ReLU activations (an exact zero on qmin included): uint8 codes
    and the per-tensor scale bit-equal."""
    x = np.maximum(np.random.default_rng(bits).normal(size=(9, 70)),
                   0).astype(np.float32)
    qj, sj = jquant.quantize_unsigned_activations(jnp.asarray(x), bits)
    qt, st = tquant.quantize_unsigned_activations(torch.from_numpy(x), bits)
    _eq(qj, qt)
    _eq(sj, st)


@pytest.mark.parametrize("signed", [True, False])
def test_int_matmul_dequant_exact(signed):
    rng = np.random.default_rng(5 + signed)
    x = (rng.integers(-128, 128, size=(7, 96)).astype(np.int8) if signed
         else rng.integers(0, 256, size=(7, 96)).astype(np.uint8))
    w = rng.integers(-128, 128, size=(96, 33)).astype(np.int8)
    xs = rng.random((7, 1)).astype(np.float32)
    ws = rng.random((1, 33)).astype(np.float32)
    _eq(jquant.int_matmul_dequant(*map(jnp.asarray, (x, w, xs, ws))),
        tquant.int_matmul_dequant(*map(torch.from_numpy, (x, w, xs, ws))))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [True, False])
def test_plane_shape_helpers_exact(bits, signed):
    """msb_plane_width, plane_value_range (every plane) and planes_count;
    every plane of a decomposition lies in its range."""
    assert tdec.msb_plane_width(bits, signed) == \
        jdec.msb_plane_width(bits, signed)
    lo, hi = jdec.weight_range(bits, signed)
    w = np.random.default_rng(bits).integers(lo, hi + 1, size=(40, 30))
    planes = tdec.decompose_weights(torch.from_numpy(w), bits, signed=signed)
    assert tdec.planes_count(planes) == jdec.planes_count(
        jdec.decompose_weights(jnp.asarray(w), bits, signed=signed))
    for c in range(tdec.num_planes(bits, signed)):
        rng_ = tdec.plane_value_range(bits, c, signed)
        assert rng_ == jdec.plane_value_range(bits, c, signed)
        assert rng_[0] <= int(planes[c].min()) <= int(planes[c].max()) \
            <= rng_[1]


@pytest.mark.parametrize("eff", [2, 4, 6, 8])
@pytest.mark.parametrize("signed", [True, False])
def test_superplane_prefix_exact(eff, signed):
    lo, hi = jdec.weight_range(8, signed)
    q8 = np.random.default_rng(eff).integers(lo, hi + 1, size=(24, 20))
    pj = jdec.decompose_superplanes(jnp.asarray(q8), signed=signed)
    pt = tdec.decompose_superplanes(torch.from_numpy(q8), signed=signed)
    _eq(jdec.superplane_prefix(pj, eff), tdec.superplane_prefix(pt, eff))
    got = tdec.recompose_superplane_prefix(pt, eff, signed=signed)
    _eq(jdec.recompose_superplane_prefix(pj, eff, signed=signed), got)
    if signed:
        np.testing.assert_array_equal(got.numpy(), q8 >> (8 - eff))


@pytest.mark.parametrize("layout", [((3, 8), (2, 4), (2, 2)), ((4, 6),),
                                    ((1, 2), (5, 8)), ((2, 4), (1, 6),
                                                       (2, 2))])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_decomposed_matmul_grouped_exact(layout, lead):
    """The grouped oracle equals the reference's, and the grouped GEMM's
    plain path (ops.bitserial_matmul_planes(row_groups=) on CPU tensors)
    bit for bit, with an extra leading axis too."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(len(layout) + len(lead))
    m = sum(r for r, _ in layout)
    q8 = rng.integers(-128, 128, size=(64, 40))
    x = rng.integers(-128, 128, size=(m,) + lead + (64,)).astype(np.int8)
    pj = jdec.decompose_superplanes(jnp.asarray(q8))
    pt = tdec.decompose_superplanes(torch.from_numpy(q8))
    got = tdec.decomposed_matmul_grouped(torch.from_numpy(x), pt, layout)
    _eq(jdec.decomposed_matmul_grouped(jnp.asarray(x), pj, layout), got)
    qw = ops.QuantizedWeight(planes=pt.contiguous(),
                             scale=torch.ones((1, 40)), w_bits=8,
                             msb_first=True)
    _eq(got.numpy(), ops.bitserial_matmul_planes(torch.from_numpy(x), qw,
                                                 row_groups=layout))
    with pytest.raises(ValueError, match="row_groups cover"):
        tdec.decomposed_matmul_grouped(torch.from_numpy(x[1:]), pt, layout)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("a_bits", [8, 4])
def test_quantized_matmul_ref_exact(bits, a_bits):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(bits * 10 + a_bits)
    lo, hi = jdec.weight_range(bits, True)
    w = rng.integers(lo, hi + 1, size=(64, 24))
    x = rng.normal(size=(6, 64)).astype(np.float32)
    ws = rng.random((1, 24)).astype(np.float32)
    _eq(jref.quantized_matmul_ref(jnp.asarray(x),
                                  jdec.decompose_weights(jnp.asarray(w), bits),
                                  jnp.asarray(ws), bits, a_bits),
        tref.quantized_matmul_ref(torch.from_numpy(x),
                                  tdec.decompose_weights(torch.from_numpy(w),
                                                         bits),
                                  torch.from_numpy(ws), bits, a_bits))


def test_slot_axis_and_store_planes_are_the_references():
    """``SLOT_AXIS`` names the slot axis of a spilled snapshot (the
    reference's period-stacked layout); ``STORE_PLANES`` the grouped
    kernels' default store."""
    from repro.kernels import grouped_matmul as jgmm
    from repro.serve import slots as jslots
    from repro_torch.kernels import grouped_matmul as tgmm
    from repro_torch.serve import slots as tslots
    assert tslots.SLOT_AXIS == jslots.SLOT_AXIS
    assert tgmm.STORE_PLANES == jgmm.STORE_PLANES
    snap = [{"pos0": {"k": torch.zeros(1, 3, 5)}} for _ in range(2)]
    leaf = tslots.spill_tree(snap)["pos0"]["k"]
    assert leaf.shape[0] == 2 and leaf.shape[tslots.SLOT_AXIS] == 1


def test_core_exports_the_reference_names():
    import repro.core as jcore
    import repro_torch.core as tcore
    names = {n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))}
    assert names <= set(dir(tcore)), sorted(names - set(dir(tcore)))


def test_policy_and_schedule_mirror_the_reference():
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
    js = jpol.uniform_schedule(tiers, backend="pallas")
    ts = tpol.uniform_schedule(tiers, backend="cuda")
    assert ts.tier_names == js.tier_names
    assert ts.default_tier == js.default_tier
    for t in tiers:
        a, b = js.lookup("layers.pos0.attn.q_proj", t), \
            ts.lookup("layers.pos0.attn.q_proj", t)
        assert (a.w_bits, a.a_bits, a.w_signed, a.a_signed) == \
            (b.w_bits, b.a_bits, b.w_signed, b.a_signed)
        assert tpol.JAX_BACKEND_NAME[b.backend] == a.backend
    assert ts.prepare_policy().default.w_bits == 8
    assert set(tpol.BACKENDS) - {"cuda"} == set(jpol.BACKENDS) - {"pallas"}
    with pytest.raises(ValueError, match="integer serving backend"):
        tpol.uniform_schedule({"a": (8, 8)}, backend="dense")
    with pytest.raises(ValueError, match="plane-truncatable"):
        tpol.uniform_schedule({"a": (6, 8), "b": (3, 3)})
    pol = tpol.PrecisionPolicy(
        rules={"layers.*.mlp.*": tpol.LayerPrecision(4, 8, backend="cuda")},
        default=tpol.LayerPrecision(8, 8, backend="cuda"))
    assert pol.lookup("layers.pos0.mlp.up_proj").w_bits == 4
    assert pol.lookup("lm_head").w_bits == 8


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.serve.engine, repro_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_jax_or_reference_imports_in_the_port():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{f}:{i + 1}: {line}" for f in files
           for i, line in enumerate(f.read_text().splitlines())
           if pat.match(line)]
    assert not bad, bad
