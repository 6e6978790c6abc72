"""repro_torch's array simulators and hardware model held EXACTLY against
the JAX package on the same numpy inputs made from a seed.

* Simulators: ``activation_bitplanes``, ``bitserial_mac``,
  ``csa_tree_sum``, ``msb_path_activity`` and ``pe_array_matmul`` (the
  product and every ``PEArrayStats`` field), for every weight width 2-8,
  activation width 2-8 and each pair of signs; the products also equal
  the exact int64 ``a @ w``.  The reference runs op by op (eager jnp).
* ``hwmodel``: every function the reference's ``tests/test_hwmodel.py``
  covers, plus the tier pricing, equals the reference's value exactly (the
  same float64 numpy arithmetic); ``allocate_bits_by_sensitivity`` gives
  equal rules.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adder_tree as jtree
from repro.core import bitserial as jbits
from repro.core import pe_array as jpe
from repro.core import policy as jpol
from repro.hwmodel import adder_tree_cost as jatc
from repro.hwmodel import breakdown as jbd
from repro.hwmodel import energy as jen
from repro.hwmodel import mobilenet as jmn
from repro_torch.core import adder_tree as ttree
from repro_torch.core import bitserial as tbits
from repro_torch.core import decompose as tdec
from repro_torch.core import pe_array as tpe
from repro_torch.core import policy as tpol
from repro_torch.hwmodel import adder_tree_cost as tatc
from repro_torch.hwmodel import breakdown as tbd
from repro_torch.hwmodel import energy as ten
from repro_torch.hwmodel import mobilenet as tmn

BITS = list(range(2, 9))
# (a_signed, w_signed)
SIGNS = [(True, True), (False, False), (True, False), (False, True)]


def _eq(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, (want.shape, got.shape)
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    np.testing.assert_array_equal(got, want)


def _operands(w_bits, a_bits, a_signed, w_signed, b=3, r=80, c=24):
    """Integer activations [b, r] and weights [r, c] spanning their full
    ranges (r = 80: one full 64-row tile and one partial)."""
    rng = np.random.default_rng(100 * w_bits + 10 * a_bits
                                + 2 * a_signed + w_signed)
    alo, ahi = tdec.weight_range(a_bits, a_signed)
    wlo, whi = tdec.weight_range(w_bits, w_signed)
    a = rng.integers(alo, ahi + 1, size=(b, r)).astype(np.int32)
    w = rng.integers(wlo, whi + 1, size=(r, c)).astype(np.int32)
    a[0, :2], w[:2, 0] = (alo, ahi), (wlo, whi)
    return a, w


@pytest.mark.parametrize("signs", SIGNS, ids=lambda s: "a%sw%s" % (
    "s" if s[0] else "u", "s" if s[1] else "u"))
@pytest.mark.parametrize("a_bits", BITS)
@pytest.mark.parametrize("w_bits", BITS)
def test_simulators_exact(w_bits, a_bits, signs):
    a_signed, w_signed = signs
    a, w = _operands(w_bits, a_bits, a_signed, w_signed)
    exact = a.astype(np.int64) @ w.astype(np.int64)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)

    jb, jw = jbits.activation_bitplanes(jnp.asarray(a), a_bits,
                                        signed=a_signed)
    tb, tw_ = tbits.activation_bitplanes(ta, a_bits, signed=a_signed)
    _eq(jb, tb)
    _eq(jw, tw_)

    got = tbits.bitserial_mac(ta, tw, a_bits, w_bits, a_signed=a_signed,
                              w_signed=w_signed)
    _eq(jbits.bitserial_mac(jnp.asarray(a), jnp.asarray(w), a_bits, w_bits,
                            a_signed=a_signed, w_signed=w_signed), got)
    np.testing.assert_array_equal(got.numpy(), exact)

    jout, jstats = jpe.pe_array_matmul(
        jnp.asarray(a), jnp.asarray(w), w_bits=w_bits, a_bits=a_bits,
        a_signed=a_signed, w_signed=w_signed)
    tout, tstats = tpe.pe_array_matmul(
        ta, tw, w_bits=w_bits, a_bits=a_bits, a_signed=a_signed,
        w_signed=w_signed)
    _eq(jout, tout)
    np.testing.assert_array_equal(tout.numpy(), exact)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.macs_per_cycle == jstats.macs_per_cycle
    assert tstats.tops(500.0) == jstats.tops(500.0)

    # The CSA tree on one row tile's products (3-bit signed, in [-4, 3]).
    planes = tdec.decompose_weights(tw, w_bits, signed=w_signed)
    prods = (tb[:, :, :64, None].to(torch.int32)
             * planes[-1, None, None, :64].to(torch.int32))
    for axis in (0, 2, 3):
        _eq(jtree.csa_tree_sum(jnp.asarray(prods.numpy()), axis=axis),
            ttree.csa_tree_sum(prods, axis=axis))
        _eq(jtree.msb_path_activity(jnp.asarray(prods.numpy()), axis=axis),
            ttree.msb_path_activity(prods, axis=axis))
    np.testing.assert_array_equal(ttree.csa_tree_sum(prods, axis=2).numpy(),
                                  prods.sum(dim=2).numpy())


def test_csa_split_paths_exact():
    """Every 3-bit product value, and the unsigned-column case (all MSBs
    zero: the quiet path)."""
    rng = np.random.default_rng(7)
    p = rng.integers(-4, 4, size=(5, 64, 33)).astype(np.int32)
    unsigned = rng.integers(0, 4, size=(5, 64, 33)).astype(np.int32)
    for x in (p, unsigned):
        jm, jl = jtree.split_products(jnp.asarray(x))
        tm, tl = ttree.split_products(torch.from_numpy(x))
        _eq(jm, tm)
        _eq(jl, tl)
        _eq(jtree.csa_tree_sum(jnp.asarray(x), axis=1),
            ttree.csa_tree_sum(torch.from_numpy(x), axis=1))
        _eq(jtree.msb_path_activity(jnp.asarray(x), axis=1),
            ttree.msb_path_activity(torch.from_numpy(x), axis=1))
    assert float(ttree.msb_path_activity(torch.from_numpy(unsigned)).max()) \
        == 0.0


@pytest.mark.parametrize("indep", [True, False])
@pytest.mark.parametrize("w_bits", BITS)
def test_array_geometry_exact(w_bits, indep):
    """Logical columns, utilization and peak TOPS of the modeled array at
    every operating point; the port's config carries ``clk_mhz``."""
    jc = jpe.PEArrayConfig(independent_shift_add=indep, clk_mhz=500.0)
    tc = tpe.PEArrayConfig(independent_shift_add=indep, clk_mhz=500.0)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tpe.PEArrayConfig().clk_mhz == jpe.PEArrayConfig().clk_mhz
    for signed in (True, False):
        assert tpe.logical_columns_per_pass(tc, w_bits, signed) \
            == jpe.logical_columns_per_pass(jc, w_bits, signed)
        assert tpe.array_utilization(tc, w_bits, signed) \
            == jpe.array_utilization(jc, w_bits, signed)
    for a_bits in BITS:
        assert tpe.peak_tops(tc, w_bits, a_bits) \
            == jpe.peak_tops(jc, w_bits, a_bits)


def _schedule(mod):
    base = mod.LayerPrecision(w_bits=8, a_bits=8, backend="decomposed")
    return mod.PrecisionSchedule(
        tiers={"auto": base, "base": base, "lo": dataclasses.replace(
            base, w_bits=2, a_bits=4)},
        rules={"auto": {"layers.pos0.mlp.*": dataclasses.replace(
            base, w_bits=4)}})


_MACS = {"layers.pos0.attn.q_proj": 4096, "layers.pos0.mlp.up_proj": 12288,
         "layers.pos0.mlp.down_proj": 12288, "lm_head": 65536}

# name -> f(energy, breakdown, adder_tree_cost, mobilenet, policy): every
# function of the reference's tests/test_hwmodel.py, and the pricing.
HWMODEL_CASES = {
    "table2_model": lambda en, bd, atc, mn, pol: atc.table2_model(),
    "table2_model_32": lambda en, bd, atc, mn, pol: atc.table2_model(32),
    "bat_csa_costs": lambda en, bd, atc, mn, pol: (
        dataclasses.asdict(atc.bat_cost()),
        dataclasses.asdict(atc.csa_split_cost()),
        atc.csa_split_cost().area_ge, atc.low_msb_split(),
        atc.wallace_reduce([64, 64, 7])),
    "pe_efficiency": lambda en, bd, atc, mn, pol: [
        en.pe_efficiency(w, a) for (w, a) in en.PAPER_PE_EFF],
    "pe_power_w": lambda en, bd, atc, mn, pol: [
        en.pe_power_w(w, a, toggle=t, voltage=v, freq_mhz=f)
        for w in BITS for a in (2, 4, 8) for t in (0.2, 0.5)
        for v, f in ((0.72, 500.0), (1.05, 1000.0))],
    "coeffs": lambda en, bd, atc, mn, pol: (
        en._solve_power_coeffs().tolist(),
        [en._features(w, a).tolist() for w in BITS for a in BITS]),
    "peak_throughput": lambda en, bd, atc, mn, pol: (
        en.peak_throughput_tops(), [en.tops(w, a, freq_mhz=f) for w in BITS
                                    for a in BITS for f in (500.0, 1000.0)]),
    "table3_ours": lambda en, bd, atc, mn, pol: en.table3_ours(),
    "improvement": lambda en, bd, atc, mn, pol: en.improvement_vs_bitsystolic(),
    "fig8_curve": lambda en, bd, atc, mn, pol: [
        en.fig8_curve(w, a) for w, a in ((8, 8), (4, 4), (2, 2))],
    "efficiency_energy": lambda en, bd, atc, mn, pol: [
        (en.accelerator_efficiency(w, a), en.energy_per_mac_j(w, a),
         en.energy_per_mac_j(w, a, accelerator=False, toggle=0.3))
        for w in BITS for a in BITS],
    "tier_cost": lambda en, bd, atc, mn, pol: [
        en.tier_cost(w, a, freq_mhz=f, toggle=t) for w in BITS
        for a in (2, 4, 8) for f, t in ((500.0, 0.5), (1000.0, 0.2))],
    "precision_tier_table": lambda en, bd, atc, mn, pol:
        en.precision_tier_table({"8/8": (8, 8), "4/4": (4, 4),
                                 "2/2": (2, 2)}, toggle=0.4),
    "cycles_per_mac": lambda en, bd, atc, mn, pol: [
        en.cycles_per_mac(w, a, freq_mhz=f) for w in BITS for a in BITS
        for f in (500.0, 1000.0)],
    "per_layer_cost": lambda en, bd, atc, mn, pol: {
        k: v.tolist() for k, v in en.per_layer_cost(
            [4096, 12288, 65536, 1024, 7], [2, 4, 8, 6, 2], 8).items()},
    "tier_pricing": lambda en, bd, atc, mn, pol: [
        (en.tier_cycles_per_token(s, m), en.relative_tier_costs(s, m),
         en.fastest_tier(s, m))
        for s in (_schedule(pol),) for m in (None, _MACS)],
    "speculative": lambda en, bd, atc, mn, pol: [
        en.speculative_cycles_per_token(r, k, 1.0, 4.0)
        for r in (0.0, 0.3, 1.0) for k in (1, 4)],
    "fig7_area": lambda en, bd, atc, mn, pol: (
        bd.area_breakdown(), bd.area_fractions(), bd.indep_path_fraction()),
    "fig7_power": lambda en, bd, atc, mn, pol: [
        bd.power_breakdown(w, a) for w, a in ((8, 8), (4, 4), (2, 2))],
    "mobilenet_layers": lambda en, bd, atc, mn, pol: (
        [dataclasses.asdict(l) for l in mn.mobilenet_v2_layers()],
        mn.total_macs(), mn.total_macs(mn.mobilenet_v2_layers(160))),
    "mobilenet_allocation": lambda en, bd, atc, mn, pol: [
        mn.allocate_bits(b) for b in (3.0, 3.25, 3.5, 3.75, 4.0, 7.0)],
    "mobilenet_energy": lambda en, bd, atc, mn, pol: [
        (mn.power_reduction_vs_8bit(b), mn.throughput_speedup_vs_8bit(b))
        for b in (3.0, 3.5, 3.75, 4.0, 7.0)],
    "mobilenet_fps": lambda en, bd, atc, mn, pol: [
        (mn.inference_cycles(bits), mn.inference_fps(bits),
         mn.inference_energy_j(bits))
        for b in (2, 4, 8)
        for bits in ({l.name: b for l in mn.mobilenet_v2_layers()},)],
}


@pytest.mark.parametrize("case", sorted(HWMODEL_CASES))
def test_hwmodel_equals_reference(case):
    fn = HWMODEL_CASES[case]
    want = fn(jen, jbd, jatc, jmn, jpol)
    got = fn(ten, tbd, tatc, tmn, tpol)
    assert got == want


def test_hwmodel_constants_equal():
    for name in ("CAL_VOLTAGE", "CAL_FREQ_MHZ", "CAL_TOGGLE", "PEAK_VOLTAGE",
                 "PEAK_FREQ_MHZ", "PAPER_PE_EFF", "PAPER_ACCEL_EFF",
                 "PAPER_PEAK_TOPS", "ACCEL_OVERHEAD", "STATIC_FRACTION",
                 "TABLE3_OTHERS"):
        assert getattr(ten, name) == getattr(jen, name), name
    assert ten._COEFFS.tolist() == jen._COEFFS.tolist()
    assert tatc.PAPER_TABLE2 == jatc.PAPER_TABLE2
    assert tbd.PAPER_INDEP_FRACTION == jbd.PAPER_INDEP_FRACTION
    assert tmn.PAPER_REDUCTION == jmn.PAPER_REDUCTION
    # The modeled accelerator's Table III figures, as the paper states them.
    assert ten.peak_throughput_tops() == pytest.approx(4.09, rel=0.01)
    assert ten.table3_ours()["eff_2bit"] == pytest.approx(68.94, rel=0.01)


@pytest.mark.parametrize("choices,avg", [
    ((2, 4, 6, 8), 4.0), ((2, 4, 6, 8), 5.5), ((2, 3, 4, 5, 6, 8), 3.25),
    ((2, 4), 2.0)])
def test_allocate_bits_by_sensitivity_equal_rules(choices, avg):
    rng = np.random.default_rng(len(choices) + int(avg * 4))
    names = [f"layers.pos{i}.mlp.up_proj" for i in range(9)]
    sens = {n: float(v) for n, v in zip(names, rng.uniform(0.01, 10.0, 9))}
    counts = {n: int(v) for n, v in zip(names, rng.integers(10, 1000, 9))}
    want = jpol.allocate_bits_by_sensitivity(sens, counts, avg,
                                             choices=choices, a_bits=4)
    got = tpol.allocate_bits_by_sensitivity(sens, counts, avg,
                                            choices=choices, a_bits=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.average_bits(names, [counts[n] for n in names]) \
        == want.average_bits(names, [counts[n] for n in names])
    with pytest.raises(ValueError):
        tpol.allocate_bits_by_sensitivity(sens, counts, avg, choices=(1, 4))
