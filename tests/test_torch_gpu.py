"""repro_torch on a CUDA card: every kernel wrapper launches its kernel for
a CUDA tensor (and counts it), equals its plain version bit for bit, and
refuses what the kernel does not take; a reduced engine serves through
the kernels.  Needs no jax.  Every test is marked ``gpu`` and skips
without a card (decided in the ``gen`` fixture); on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import decompose
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request
from repro_torch.spec import SpecConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode; their "
                    "plain versions are tested on the CPU)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _counted(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


def _act_rows(gen, m, k, qmaxes, signed):
    """f32 [m, k] normal rows (x3); every row 4j + 1 on .5 boundaries after
    the divide at its qmax (amax = qmax / 8, scale = 1/8, x / scale =
    n + 1/2), every row 4j + 3 zero (scale = 1e-8 * (1/qmax))."""
    x = torch.randn((m, k), device="cuda", generator=gen) * 3
    for r in range(1, m, 4):
        q = qmaxes[r % len(qmaxes)]
        n = torch.randint(-int(q) if signed else 0, int(q), (k,),
                          device="cuda", generator=gen)
        x[r] = (n.float() + 0.5) / 8
        x[r, 0] = (-q if signed else q) / 8
    x[3::4] = 0
    return x


@pytest.mark.parametrize("k", [96, 4096, 4100, 12288])
@pytest.mark.parametrize("m", [1, 5, 8, 33, 64])
def test_act_quant_kernels(gen, m, k):
    """Both kernels bit-equal to their plain versions on bf16 and f32 rows,
    without and with a row gather (a shuffle with a repeated row)."""
    perm = torch.randperm(m, device="cuda", generator=gen)
    perm[-1] = perm[0]
    rows_qmax = (127.0, 7.0, 1.0)
    qmax = torch.tensor(rows_qmax, device="cuda").repeat(m)[:m, None]
    for dtype, pdtype in ((torch.float32, torch.int64),
                          (torch.bfloat16, torch.int32)):
        for p in (None, perm.to(pdtype)):
            for bits, signed in [(b, True) for b in range(2, 9)] + \
                    [(8, False)]:
                q = float((1 << (bits - 1)) - 1 if signed else (1 << bits) - 1)
                x = _act_rows(gen, m, k, [q], signed).to(dtype)
                got = _counted("act_quant", lambda: aq.act_quant(
                    x, bits=bits, signed=signed, perm=p))
                want = ref.act_quant_ref(x, bits=bits, signed=signed, perm=p)
                assert torch.equal(got[0], want[0]), (dtype, p, bits, signed)
                assert torch.equal(got[1], want[1]), (dtype, p, bits, signed)
            x = _act_rows(gen, m, k, rows_qmax, True).to(dtype)
            got = _counted("act_quant_rows",
                           lambda: aq.act_quant_rows(x, qmax, perm=p))
            want = ref.act_quant_rows_ref(x, qmax, perm=p)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (dtype, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4096, 12288])
def test_act_quant_kernels_take_views(gen, dtype, k):
    """Rows 8 elements apart (the register path with a row stride) and a
    base one element past a 16-byte boundary (the generic path)."""
    x = (torch.randn((8, k + 8), device="cuda", generator=gen) * 3).to(dtype)
    flat = torch.cat([x.new_zeros(1), x[:, :k].reshape(-1)])
    qmax = torch.full((8, 1), 7.0, device="cuda")
    for view in (x[:, :k], flat[1:].view(8, k)):
        got = _counted("act_quant", lambda: aq.act_quant(view))
        want = ref.act_quant_ref(view)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = _counted("act_quant_rows", lambda: aq.act_quant_rows(view, qmax))
        want = ref.act_quant_rows_ref(view, qmax)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,k,n", [
    (5, 4100, 1000), (8, 64, 64), (40, 37, 33),
    # Split-K (narrow N, deep K), a ragged row tile with ragged K and N, and
    # one row against a wide weight.
    (16, 4096, 1024), (17, 4100, 1000), (64, 12288, 4096), (1, 4096, 8192),
    # mamba2-1.3b's in_proj (N = 8512: a column tail past the 128-column
    # tile) in prefill and decode, and an expert of llama4 (K = 5120).
    (64, 2048, 8512), (8, 2048, 8512), (8, 5120, 8192)])
def test_gemm_kernels(gen, m, k, n):
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    planes = decompose.decompose_superplanes(torch.randint(
        -128, 128, (k, n), dtype=torch.int8, device="cuda",
        generator=gen)).contiguous()
    for p in (1, 4):
        sh = decompose.prefix_shifts(p)
        got = _counted("bitserial_matmul",
                       lambda: bsm.bitserial_matmul(x, planes[:p], sh))
        assert torch.equal(got, ref.bitserial_matmul_ref(x, planes[:p], sh))
    a = (m + 1) // 2
    mult = torch.from_numpy(decompose.prefix_multipliers(
        ((a, 4), (m - a, 2)))).cuda()
    xs = torch.rand((m, 1), device="cuda", generator=gen) * 1e-2
    ws = torch.rand((2, n), device="cuda", generator=gen) * 1e-2
    rg = torch.tensor([0] * a + [1] * (m - a), dtype=torch.int32,
                      device="cuda")
    got = _counted("grouped_dequant_matmul",
                   lambda: gmm.grouped_dequant_matmul(x, planes, mult, xs, ws,
                                                      rg))
    assert torch.equal(got, ref.grouped_dequant_matmul_ref(x, planes, mult,
                                                           xs, ws, rg))
    # The byte-packed store of the same weights, both signs.
    packed = ops.pack_planes(planes.flip(0), 8)
    for signed in (True, False):
        lay = dict(packed=True, signed=signed)
        got = _counted("grouped_dequant_matmul",
                       lambda: gmm.grouped_dequant_matmul(
                           x, packed, mult, xs, ws, rg, **lay))
        assert torch.equal(got, ref.grouped_dequant_matmul_ref(
            x, packed, mult, xs, ws, rg, **lay))
        got = _counted("grouped_matmul",
                       lambda: gmm.grouped_matmul(x, packed, mult, **lay))
        assert torch.equal(got, ref.grouped_matmul_ref(x, packed, mult, **lay))
    got = _counted("grouped_matmul", lambda: gmm.grouped_matmul(x, planes, mult))
    assert torch.equal(got, ref.grouped_matmul_ref(x, planes, mult))
    for w_bits in (2, 4, 6, 8):
        wp = packed & ((1 << w_bits) - 1)
        for eff in range(2, w_bits + 1, 2):
            for signed in (True, False):
                got = _counted("packed_bitserial_matmul",
                               lambda: bsm.packed_bitserial_matmul(
                                   x, wp, w_bits=w_bits, eff_bits=eff,
                                   signed=signed))
                assert torch.equal(got, ref.packed_bitserial_matmul_ref(
                    x, wp, w_bits, eff, signed)), (w_bits, eff, signed)


@pytest.mark.parametrize("m", [3, 40])
def test_shift_gemms_take_rows_that_are_not_16_byte_aligned(gen, m):
    """x and the store one byte past an aligned address: the kernels' masked
    load path, at an aligned K and N that would otherwise copy 16 bytes."""
    k, n = 4096, 1024
    xbuf = torch.randint(-128, 128, (m * k + 1,), dtype=torch.int8,
                         device="cuda", generator=gen)
    x = xbuf[1:].view(m, k)
    planes = decompose.decompose_superplanes(torch.randint(
        -128, 128, (k, n), dtype=torch.int8, device="cuda",
        generator=gen)).contiguous()
    pbuf = torch.empty(planes.numel() + 1, dtype=torch.int8, device="cuda")
    pbuf[1:] = planes.reshape(-1)
    shifted = pbuf[1:].view(planes.shape)
    sh = decompose.prefix_shifts(4)
    got = _counted("bitserial_matmul",
                   lambda: bsm.bitserial_matmul(x, shifted, sh))
    assert torch.equal(got, ref.bitserial_matmul_ref(x, planes, sh))
    packed = ops.pack_planes(planes.flip(0), 8)
    qbuf = torch.empty(packed.numel() + 1, dtype=torch.uint8, device="cuda")
    qbuf[1:] = packed.reshape(-1)
    got = _counted("packed_bitserial_matmul",
                   lambda: bsm.packed_bitserial_matmul(
                       x, qbuf[1:].view(k, n), w_bits=8, eff_bits=6))
    assert torch.equal(got, ref.packed_bitserial_matmul_ref(x, packed, 8, 6))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randint(0, 255, (4, 64), dtype=torch.uint8, device="cuda")
    planes = torch.zeros((1, 64, 8), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="int8"):
        bsm.bitserial_matmul(x, planes, (0,))
    with pytest.raises(ValueError, match="contiguous"):
        aq.act_quant(torch.randn((64, 4), device="cuda").T)
    with pytest.raises(ValueError, match="perm"):
        aq.act_quant_rows(torch.randn((4, 64), device="cuda"),
                          torch.ones((4, 1), device="cuda"),
                          perm=torch.arange(4, device="cuda").float())
    with pytest.raises(ValueError, match="perm"):
        aq.act_quant(torch.randn((4, 64), device="cuda"),
                     perm=torch.arange(4))
    xi = x.to(torch.int8)
    packed = torch.zeros((64, 8), dtype=torch.uint8, device="cuda")
    mult = torch.ones((4, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        bsm.packed_bitserial_matmul(xi, packed.to(torch.int8), w_bits=8)
    with pytest.raises(ValueError, match="int8"):
        bsm.packed_bitserial_matmul(x, packed, w_bits=8)
    with pytest.raises(ValueError, match="strided"):
        bsm.packed_bitserial_matmul(xi, torch.zeros(
            (8, 64), dtype=torch.uint8, device="cuda").T, w_bits=8)
    with pytest.raises(ValueError, match="packed=True takes a uint8"):
        gmm.grouped_matmul(xi, planes, mult, packed=True)
    with pytest.raises(ValueError, match="packed=False takes planes"):
        gmm.grouped_matmul(xi, packed, mult)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        gmm.grouped_matmul(xi, packed, mult.to(torch.int64), packed=True)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("packed", [False, True])
def test_shift_gemms_refuse_a_plan_off_the_core_layout(gen, monkeypatch,
                                                       packed):
    """The plan's shared bytes must equal plane_mma.cuh's layout (kStages
    slots of weight tiles and a padded x tile): a plan that differs is
    refused, not launched, and not counted."""
    real = bsm.plan

    def off(*args, **kwargs):
        pl = real(*args, **kwargs)
        return pl._replace(smem=pl.smem + 16)
    monkeypatch.setattr(bsm, "plan", off)
    x = torch.randint(-128, 128, (8, 256), dtype=torch.int8, device="cuda",
                      generator=gen)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="failed"):
        if packed:
            bsm.packed_bitserial_matmul(x, torch.zeros(
                (256, 256), dtype=torch.uint8, device="cuda"), w_bits=4)
        else:
            bsm.bitserial_matmul(x, torch.zeros(
                (2, 256, 256), dtype=torch.int8, device="cuda"), (0, 2))
    assert _build.LAUNCHES == before


def _grouped_case(gen, m, k, n, layout, offset=0):
    """x, MSB-first planes, their packed store, and the grouped tables of
    ``layout`` ((rows, planes) per tier group): mult, x_scale, w_scale (one
    row per group) and row_group.  ``offset`` > 0 puts x and both stores
    that many bytes past an aligned address (the masked load path)."""
    def shifted(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device="cuda")
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(t.shape)
    x = shifted(torch.randint(-128, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=gen))
    full = decompose.decompose_superplanes(torch.randint(
        -128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen))
    pmax = max(p for _, p in layout)
    planes = shifted(full[:pmax].contiguous())
    packed = shifted(ops.pack_planes(full.flip(0), 8))
    mult = torch.from_numpy(decompose.prefix_multipliers(layout)).cuda()
    xs = torch.rand((m, 1), device="cuda", generator=gen) * 1e-2 + 1e-4
    ws = torch.rand((len(layout), n), device="cuda", generator=gen) * 1e-2
    rg = torch.from_numpy(np.repeat(np.arange(len(layout), dtype=np.int32),
                                    [r for r, _ in layout])).cuda()
    return x, planes, packed, mult, xs, ws, rg


def _hold_grouped(x, planes, packed, mult, xs, ws, rg):
    """Kernels 4 and 6 on the int8 prefix and on the packed store (signed
    and unsigned), each bit-equal to its plain version and counted once."""
    cases = [(planes, {})] + [(packed, dict(packed=True, signed=sg))
                              for sg in (True, False)]
    for w, lay in cases:
        got = _counted("grouped_dequant_matmul",
                       lambda: gmm.grouped_dequant_matmul(x, w, mult, xs, ws,
                                                          rg, **lay))
        want = ref.grouped_dequant_matmul_ref(x, w, mult, xs, ws, rg, **lay)
        assert torch.equal(got, want), lay
        got = _counted("grouped_matmul",
                       lambda: gmm.grouped_matmul(x, w, mult, **lay))
        assert torch.equal(got, ref.grouped_matmul_ref(x, w, mult, **lay)), \
            lay


def _layouts(m, pmax):
    """One-tier batches of ``pmax`` planes and, with two or more rows, the
    rows split between ``pmax`` planes and fewer."""
    out = [((m, pmax),)]
    if m >= 2:
        a = (m + 1) // 2
        out.append(((a, pmax), (m - a, max(1, pmax - 2))))
    if m >= 3 and pmax >= 3:
        a = m // 3
        out.append(((a, pmax), (a, 2), (m - 2 * a, 1)))
    return out


@pytest.mark.parametrize("pmax", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 3, 8, 17, 40])
def test_grouped_kernels_at_decode_rows(gen, m, pmax):
    """Kernels 4 and 6 at every decode batch kind: one tier or several,
    Pmax 1-4, both layouts, at a split (K = 4096, N = 1024) and a wide
    (K = 512, N = 12288) shape."""
    for k, n in ((4096, 1024), (512, 12288)):
        for layout in _layouts(m, pmax):
            _hold_grouped(*_grouped_case(gen, m, k, n, layout))


@pytest.mark.parametrize("k,n", [(2048, 8512), (5120, 8192)])
def test_kernels_2_and_4_at_ssm_and_expert_shapes(gen, k, n):
    """Kernels 2 and 4 at mamba2-1.3b's in_proj (K = 2048, N = 8512) and at
    a llama4 expert's gate/up (an [8, 1, 5120] capacity-1 buffer, most of
    its rows zero), three tiers, against their plain versions."""
    m = 8
    x = (torch.randn((m, k), device="cuda", generator=gen) * 3).to(
        torch.bfloat16)
    x[1::2] = 0
    x[2] = 0
    qmax = torch.tensor((127.0, 7.0, 1.0), device="cuda").repeat(m)[:m, None]
    perm = torch.randperm(m, device="cuda", generator=gen)
    got = _counted("act_quant_rows",
                   lambda: aq.act_quant_rows(x, qmax, perm=perm))
    want = ref.act_quant_rows_ref(x, qmax, perm=perm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zero = (x[perm] == 0).all(dim=1)
    assert not got[0][zero].any()
    assert torch.equal(got[1][zero, 0], 1e-8 * (1.0 / qmax[zero, 0]))
    _hold_grouped(*_grouped_case(gen, m, k, n, ((3, 4), (3, 2), (2, 1))))


def test_reduced_jamba_serves_through_the_kernels(gen):
    """The reduced hybrid (Mamba, attention, MLP and MoE layers): the
    kernel streams equal the plain (``decomposed``) replay's, with greedy
    speculation, and every serving kernel launched."""
    model = LM(reduced_config("jamba-1.5-large-398b"))
    params = model.init(gen, device="cuda")
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
    reqs = _engine_requests(tiers)
    outs = []
    for backend in ("cuda", "decomposed"):
        sched = uniform_schedule(tiers, backend=backend)
        rt = Runtime(policy=sched.policy_for(), schedule=sched)
        for spec in (False, True):
            rs = [Request(uid=r.uid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens, tier=r.tier,
                          spec=SpecConfig("2/2", 3) if spec and r.uid % 3
                          else None) for r in reqs]
            eng = ServeEngine(model, params, rt, max_batch=4, max_len=32)
            _build.reset_launches()
            outs.append(eng.run(rs))
            if backend == "cuda":
                used = ("act_quant", "act_quant_rows", "bitserial_matmul",
                        "grouped_dequant_matmul")
                assert all(_build.LAUNCHES[k] > 0 for k in used), \
                    _build.LAUNCHES
            else:
                assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert outs[0] == outs[1] == outs[2] == outs[3]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [3, 8, 17])
def test_grouped_kernels_ragged_and_unaligned(gen, m, offset):
    """Ragged K and N (4100 x 1000: no 16-byte chunks, a ragged column
    tile, a short last K slice), and rows one byte past an aligned address
    at an aligned shape, where the kernels take their masked loads."""
    k, n = (4100, 1000) if offset == 0 else (4096, 1024)
    a = (m + 2) // 3
    b = (m - a + 1) // 2
    layout = ((a, 4), (b, 2), (m - a - b, 1))
    _hold_grouped(*_grouped_case(gen, m, k, n, layout, offset))


def test_split_counters_reset_between_launches(gen):
    """Back-to-back split launches of all four GEMMs, at different shapes,
    on one stream share the split-K counters and workspace: a counter left
    non-zero, or a slice read from another launch, would show as a wrong
    result."""
    shapes = [(8, 4096, 1024), (3, 12288, 4096), (8, 4096, 1024),
              (17, 4096, 4096), (1, 256, 640), (40, 4096, 1024)]
    calls = []
    for m, k, n in shapes:
        assert bsm.plan(m, k, n, 4).splits > 1, (m, k, n)
        x, planes, packed, mult, xs, ws, rg = _grouped_case(
            gen, m, k, n, ((m, 4),))
        sh = decompose.prefix_shifts(4)
        calls += [
            (lambda a=(x, planes, mult, xs, ws, rg):
             gmm.grouped_dequant_matmul(*a),
             ref.grouped_dequant_matmul_ref(x, planes, mult, xs, ws, rg)),
            (lambda a=(x, packed, mult): gmm.grouped_matmul(*a, packed=True),
             ref.grouped_matmul_ref(x, packed, mult, packed=True)),
            (lambda a=(x, planes, sh): bsm.bitserial_matmul(*a),
             ref.bitserial_matmul_ref(x, planes, sh)),
            (lambda a=(x, packed): bsm.packed_bitserial_matmul(*a, w_bits=8),
             ref.packed_bitserial_matmul_ref(x, packed, 8, 8))]
    for _ in range(3):                 # no synchronisation between launches
        gots = [fn() for fn, _ in calls]
        torch.cuda.synchronize()
        for got, (_, want) in zip(gots, calls):
            assert torch.equal(got, want)
    key = (calls[0][1].device, torch.cuda.current_stream().cuda_stream)
    counters, _ = bsm._SCRATCH[key]
    assert not counters.any()          # every last slice reset its counter


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("field", ["smem", "workspace"])
def test_grouped_kernels_refuse_a_plan_off_the_core_layout(gen, monkeypatch,
                                                           packed, field):
    """A plan whose shared bytes, or (split launch) workspace, differ from
    plane_mma.cuh's layout is refused, not launched, and not counted."""
    real = bsm.plan

    def off(*args, **kwargs):
        pl = real(*args, **kwargs)
        return pl._replace(**{field: getattr(pl, field) + 16})
    x, planes, store, mult, xs, ws, rg = _grouped_case(gen, 8, 4096, 1024,
                                                       ((8, 4),))
    assert real(8, 4096, 1024, 4, packed).splits > 1
    w, lay = (store, {"packed": True}) if packed else (planes, {})
    monkeypatch.setattr(bsm, "plan", off)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="failed"):
        gmm.grouped_dequant_matmul(x, w, mult, xs, ws, rg, **lay)
    with pytest.raises(RuntimeError, match="failed"):
        gmm.grouped_matmul(x, w, mult, **lay)
    assert _build.LAUNCHES == before


def _engine_requests(tiers):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, 512, size=5 + i)
                    .astype(np.int32), max_new_tokens=6,
                    tier=None if tiers is None else list(tiers)[i % 3])
            for i in range(6)]


def test_reduced_engine_serves_through_the_kernels(gen):
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    params = model.init(gen, device="cuda")
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
    reqs = _engine_requests(tiers)
    outs = []
    for backend in ("cuda", "decomposed"):
        sched = uniform_schedule(tiers, backend=backend)
        eng = ServeEngine(model, params, Runtime(policy=sched.policy_for(),
                                                 schedule=sched),
                          max_batch=4, max_len=32)
        _build.reset_launches()
        outs.append(eng.run(reqs))
        if backend == "cuda":
            used = ("act_quant", "act_quant_rows", "bitserial_matmul",
                    "grouped_dequant_matmul")
            assert all(_build.LAUNCHES[k] > 0 for k in used), _build.LAUNCHES
        else:                               # the plain reference launches none
            assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert outs[0] == outs[1]


@pytest.mark.parametrize("tiered", [True, False])
def test_reduced_packed_engine_serves_through_the_kernels(gen, tiered):
    """ServeEngine(packed=True) prepares the byte store and decodes through
    the packed GEMMs only; its streams equal the int8-plane store's."""
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    params = model.init(gen, device="cuda")
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)} if tiered else None
    if tiered:
        sched = uniform_schedule(tiers, backend="cuda")
        rt = Runtime(policy=sched.policy_for(), schedule=sched)
    else:
        rt = Runtime(policy=uniform_policy(4, 8, backend="cuda"))
    reqs = _engine_requests(tiers)
    outs = []
    for packed in (False, True):
        eng = ServeEngine(model, params, rt, max_batch=4, max_len=32,
                          packed=packed)
        _build.reset_launches()
        outs.append(eng.run(reqs))
    assert outs[0] == outs[1]
    assert _build.LAUNCHES["bitserial_matmul"] == 0
    used = ("act_quant", "packed_bitserial_matmul") + \
        (("act_quant_rows", "grouped_dequant_matmul") if tiered else ())
    assert all(_build.LAUNCHES[k] > 0 for k in used), _build.LAUNCHES


# ------------------------------------------------ speculative decoding
SPEC_TIERS = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}


def _full_width(gen, packed=False, layers=4):
    """qwen3-8b at full width, ``layers`` deep, seeded weights prepared
    layer by layer into the superplane store."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import prepare_tree
    model = LM(dataclasses.replace(get_config("qwen3-8b"), num_layers=layers))
    sched = uniform_schedule(SPEC_TIERS, backend="cuda")
    params = model.init(gen, device="cuda", prepare=lambda tree, prefix:
                        prepare_tree(tree, sched.prepare_policy(),
                                     prefix=prefix, superplane=True,
                                     packed=packed))
    return model, params


def _spec_requests(vocab, spec, sampled):
    from repro_torch.spec import SamplingParams, SpecConfig
    rng = np.random.default_rng(1)
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(16, 65))).astype(np.int32), max_new_tokens=12,
        tier=list(SPEC_TIERS)[i % 3],
        spec=SpecConfig("2/2", 4) if spec and i % 3 != 2 else None,
        sampling=SamplingParams(0.8, 40, i) if sampled else None)
        for i in range(9)]


def _tiered(model, params, backend, **kw):
    sched = uniform_schedule(SPEC_TIERS, backend=backend)
    return ServeEngine(model, params, Runtime(policy=sched.policy_for(),
                                              schedule=sched),
                       **{"max_batch": 8, "max_len": 128, **kw})


@pytest.mark.parametrize("packed", [False, True])
def test_verify_window_equals_sequential_decode_at_full_width(gen, packed):
    """At 4096 wide, every verify position's logits and KV writes equal
    the sequential decode step's bit for bit: no float op in the window
    rounds by how many rows share it (mixed-tier and one-tier layouts)."""
    from repro_torch.models.layers import KVCache
    model, params = _full_width(gen, packed)
    sched = uniform_schedule(SPEC_TIERS, backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    rng = np.random.default_rng(3)
    b, w = 8, 5
    toks = torch.from_numpy(rng.integers(0, 151936, size=(b, 48))
                            .astype(np.int32)).cuda()
    lens = torch.from_numpy(rng.integers(8, 49, size=b).astype(np.int32)
                            ).cuda()
    active = torch.tensor([s % 3 != 2 for s in range(b)], device="cuda")
    for groups, order in (((("8/8", 3), ("4/4", 3), ("2/2", 2)),
                           [0, 3, 6, 1, 4, 7, 2, 5]),
                          ((("8/8", 8),), list(range(8)))):
        caches = model.init_cache(b, 128, device="cuda")
        logits, _ = model.prefill(params, rt.for_tier("8/8"), caches,
                                  tokens=toks, seq_lengths=lens)
        window = torch.cat([torch.argmax(logits[:, -1], -1).to(torch.int32)
                            [:, None], torch.randint(
                                0, 151936, (b, w - 1), device="cuda",
                                generator=gen, dtype=torch.int32)], dim=1)
        rt_v = rt.for_groups(groups, torch.tensor(order, device="cuda"))
        seq = [{p: KVCache(*[None if t is None else t.clone() for t in (
            c.k, c.v, c.k_scale, c.v_scale, c.length)])
            for p, c in layer.items()} for layer in caches]
        vlogits, _ = model.verify_step(params, rt_v, caches, tokens=window,
                                       active=active)
        for j in range(w):
            lj, _ = model.decode_step(params, rt_v, seq,
                                      tokens=window[:, j:j + 1], active=active)
            assert torch.equal(vlogits[active, j], lj[active, 0]), (groups, j)
        for la, lb in zip(caches, seq):
            for x, y in zip(vars(la["pos0"]).values(),
                            vars(lb["pos0"]).values()):
                assert x is None or torch.equal(x, y)


def test_greedy_speculative_equals_plain_at_4_layers(gen):
    model, params = _full_width(gen)
    plain = _tiered(model, params, "cuda").run(
        _spec_requests(151936, spec=False, sampled=False))
    eng = _tiered(model, params, "cuda")
    _build.reset_launches()
    assert eng.run(_spec_requests(151936, spec=True, sampled=False)) == plain
    assert eng.stats.spec_rounds > 0
    assert _build.LAUNCHES["act_quant_rows"] > 0
    assert _build.LAUNCHES["grouped_dequant_matmul"] > 0


def test_sampled_streams_cuda_equal_decomposed(gen):
    """Sampled requests, speculative and plain mixed: the kernels' run and
    the plain backend's (which launches nothing) give the same streams."""
    model, params = _full_width(gen)
    reqs = _spec_requests(151936, spec=True, sampled=True)
    outs = []
    for backend in ("cuda", "decomposed"):
        _build.reset_launches()
        outs.append(_tiered(model, params, backend).run(reqs))
        assert any(_build.LAUNCHES.values()) == (backend == "cuda")
    assert outs[0] == outs[1]


@pytest.mark.parametrize("m", [65, 192, 512])
def test_prefill_rows_past_one_row_tile(gen, m):
    """Kernels 1, 3 and 5 at the rows of a BatchServeEngine prefill (rows x
    padded prompt, up to 8 x 64): more than one 64-row tile."""
    k, n = 4096, 1024
    assert -(-m // bsm.plan(m, k, n, 4).bm) >= 2
    for dtype in (torch.float32, torch.bfloat16):
        for bits, signed in ((8, True), (4, True), (2, True), (8, False)):
            q = float((1 << (bits - 1)) - 1 if signed else (1 << bits) - 1)
            x = _act_rows(gen, m, k, [q], signed).to(dtype)
            got = _counted("act_quant", lambda: aq.act_quant(
                x, bits=bits, signed=signed))
            want = ref.act_quant_ref(x, bits=bits, signed=signed)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (dtype, bits, signed)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    planes = decompose.decompose_superplanes(torch.randint(
        -128, 128, (k, n), dtype=torch.int8, device="cuda",
        generator=gen)).contiguous()
    for p in (1, 2, 4):
        sh = decompose.prefix_shifts(p)
        got = _counted("bitserial_matmul",
                       lambda: bsm.bitserial_matmul(x, planes[:p], sh))
        assert torch.equal(got, ref.bitserial_matmul_ref(x, planes[:p], sh))
    packed = ops.pack_planes(planes.flip(0), 8)
    for eff in (2, 4, 8):
        got = _counted("packed_bitserial_matmul",
                       lambda: bsm.packed_bitserial_matmul(
                           x, packed, w_bits=8, eff_bits=eff))
        assert torch.equal(got, ref.packed_bitserial_matmul_ref(x, packed, 8,
                                                                eff))


def test_mixed_kv_arena_on_cuda_equals_cpu(gen):
    """The mixed byte-lane arena's encode (prefill, masked append) and every
    migration pair, on the card and on the CPU from the same inputs: every
    tensor equal (plain torch on both; no kernel)."""
    from repro_torch.models.layers import KVCache
    from repro_torch.serve import slots as slots_lib
    b, s, kvh, dh = 3, 40, 8, 128
    k, v = (torch.randn((b, 24, kvh, dh), device="cuda", generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    k1, v1 = (torch.randn((b, 1, kvh, dh), device="cuda", generator=gen
                          ).to(torch.bfloat16) for _ in range(2))
    for src in (16, 8, 4):
        for dst in (16, 8, 4):
            arenas = []
            for dev in ("cuda", "cpu"):
                c = KVCache.create(b, s, kvh, dh, kv_bits=(16, 8, 4),
                                   device=dev)
                c.kv_bits.copy_(torch.tensor([8, src, 4]))
                c.update(k.to(dev), v.to(dev), 0,
                         new_length=torch.tensor([24, 9, 17], device=dev))
                c.append(k1.to(dev), v1.to(dev),
                         active=torch.tensor([True, False, True], device=dev))
                arena = [{"pos0": c}]
                slots_lib.migrate_kv_tier(arena, 1, dst)
                arenas.append(c)
            for x, y in zip(arenas[0].tensors(), arenas[1].tensors()):
                assert torch.equal(x.cpu(), y), (src, dst)


# ------------------------------------------------ preemption and resume
KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}


def _kv_engine(model, params, **kw):
    sched = uniform_schedule(SPEC_TIERS, backend="cuda", kv_tiers=KV_TIERS)
    return ServeEngine(model, params, Runtime(policy=sched.policy_for(),
                                              schedule=sched),
                       **{"max_batch": 8, "max_len": 128, **kw})


@pytest.mark.parametrize("packed", [False, True])
def test_preempt_spill_resume_equals_uninterrupted(gen, packed, tmp_path):
    """At 4 layers of full width on the mixed KV arena: every request
    running after the first round is preempted (every other one spilled)
    and resumes without a kernel launch, and every stream equals the
    uninterrupted run's."""
    from repro_torch.serve.handle import RequestStatus
    model, params = _full_width(gen, packed)
    reqs = _spec_requests(151936, spec=False, sampled=False)
    want = _kv_engine(model, params).run(reqs)
    eng = _kv_engine(model, params, spill_dir=str(tmp_path))
    handles = {r.uid: eng.submit(r) for r in reqs}
    eng.step()
    running = [u for u, h in handles.items()
               if h.status is RequestStatus.RUNNING]
    for i, uid in enumerate(running):
        eng._spill_dir = str(tmp_path) if i % 2 else None
        assert eng.preempt(uid).nbytes > 0
    eng._spill_dir = str(tmp_path)
    resume, launched = eng._resume_into, []

    def resuming(*args):
        before = sum(_build.LAUNCHES.values())
        resume(*args)
        launched.append(sum(_build.LAUNCHES.values()) - before)
    eng._resume_into = resuming
    assert eng.drain() == want
    assert launched == [0] * len(running) == [0] * eng.stats.resumes
    assert eng.stats.spill_bytes > 0 and list(tmp_path.iterdir()) == []


def test_decode_dispatch_count_equals_one_step_launches(gen):
    """decode_dispatch_count at a three-tier layout equals the launches of
    one decode step there: kernels 2 and 4, once per projection and the
    head (4 and 7 per layer, 46 at 4 layers)."""
    model, params = _full_width(gen)
    eng = _kv_engine(model, params, count_dispatches=True)
    for r in _spec_requests(151936, spec=False, sampled=False):
        eng.submit(r)
    eng.step()
    groups = eng._group_layout()[0]
    assert len(groups) == 3
    n = eng.decode_dispatch_count(groups=groups)
    assert n == (4 * 4 + 1) + (7 * 4 + 1)
    assert eng.stats.decode_dispatches[groups] == n
    _build.reset_launches()
    eng._decode_chunk(eng._runtime(), 1)
    torch.cuda.synchronize()
    assert sum(_build.LAUNCHES.values()) == n
    assert _build.LAUNCHES["act_quant_rows"] == 4 * 4 + 1
    assert _build.LAUNCHES["grouped_dequant_matmul"] == 7 * 4 + 1


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("w_bits,a_bits", [(8, 8), (6, 8), (4, 4), (2, 2)])
def test_simulators_equal_kernel_3(gen, w_bits, a_bits, signed):
    """The PE-array simulator and Eq. (1) on the card equal kernel 3 on the
    LSB-first planes of ``decompose_weights`` and the exact int64 product
    (an unsigned 8-bit activation reaches kernel 3 as lo + 128 * hi)."""
    from repro_torch.core import bitserial, pe_array
    alo, ahi = decompose.weight_range(a_bits, signed)
    wlo, whi = decompose.weight_range(w_bits, signed)
    a = torch.randint(alo, ahi + 1, (8, 320), dtype=torch.int32,
                      device="cuda", generator=gen)
    w = torch.randint(wlo, whi + 1, (320, 96), dtype=torch.int32,
                      device="cuda", generator=gen)
    exact = a.cpu().long() @ w.cpu().long()
    planes = decompose.decompose_weights(w, w_bits, signed=signed)
    shifts = decompose.plane_shifts(w_bits, signed)
    if int(a.max()) <= 127:
        k3 = _counted("bitserial_matmul", lambda: bsm.bitserial_matmul(
            a.to(torch.int8), planes, shifts))
    else:
        lo, hi = (a & 127).to(torch.int8), (a >> 7).to(torch.int8)
        k3 = bsm.bitserial_matmul(lo, planes, shifts) \
            + (bsm.bitserial_matmul(hi, planes, shifts) << 7)
    sim, stats = pe_array.pe_array_matmul(a, w, w_bits=w_bits, a_bits=a_bits,
                                          a_signed=signed, w_signed=signed)
    mac = bitserial.bitserial_mac(a, w, a_bits, w_bits, a_signed=signed,
                                  w_signed=signed)
    for got in (k3, sim, mac):
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu().long(), exact)
    assert stats.macs == 8 * 320 * 96 and stats.row_tiles == 5


def test_batched_profile_equals_sequential_at_2_layers(gen):
    """Full-width qwen3-8b at 2 layers: the one-pass profiler (kernels 1
    and 4 over (6 + 1) * 2 * 8 rows) equals the sequential one (kernels 1
    and 3) bit for bit, and the plain backend's profile."""
    from repro_torch.autoprec import profile_sensitivity, random_calibration
    model, params = _full_width(gen, layers=2)
    calib = random_calibration(model.cfg, batches=1, batch=2, seq=8, seed=3)
    kw = dict(calib=calib, choices=(2, 4), layers=[
        "layers.pos0.attn.q_proj", "layers.pos0.mlp.down_proj", "lm_head"])
    _build.reset_launches()
    batched = profile_sensitivity(model, params, batched=True, block=8, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["grouped_dequant_matmul"] == 2 * 7 + 1
    assert _build.LAUNCHES["bitserial_matmul"] == 0
    _build.reset_launches()
    seq = profile_sensitivity(model, params, batched=False, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitserial_matmul"] == 7 * (2 * 7 + 1)
    assert _build.LAUNCHES["grouped_dequant_matmul"] == 0
    plain = profile_sensitivity(model, params, backend="decomposed", **kw)
    for other in (seq, plain):
        assert batched.kl == other.kl and batched.mse == other.mse
    assert all(batched.kl[n][2] > 0.0 for n in batched.layers)
