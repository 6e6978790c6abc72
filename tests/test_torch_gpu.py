"""repro_torch on a CUDA card: every kernel wrapper launches its kernel for
a CUDA tensor (and counts it), equals its plain version bit for bit, and
refuses what the kernel does not take; a reduced engine serves through
the kernels.  Needs no jax.  Every test skips without a card (decided in
the ``gen`` fixture); on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import decompose
from repro_torch.core.policy import uniform_schedule
from repro_torch.kernels import _build
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ref
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request


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


@pytest.mark.parametrize("m,k", [(5, 4100), (8, 4096), (33, 96)])
def test_act_quant_kernels(gen, m, k):
    x = torch.randn((m, k), device="cuda", generator=gen) * 3
    for bits, signed in ((8, True), (3, True), (8, False)):
        got = _counted("act_quant",
                       lambda: aq.act_quant(x, bits=bits, signed=signed))
        want = ref.act_quant_ref(x, bits=bits, signed=signed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    qmax = torch.tensor([[127.0], [7.0], [1.0]], device="cuda").repeat(m, 1)[:m]
    got = _counted("act_quant_rows", lambda: aq.act_quant_rows(x, qmax))
    want = ref.act_quant_rows_ref(x, qmax)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,k,n", [(5, 4100, 1000), (8, 64, 64), (40, 37, 33)])
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


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randint(0, 255, (4, 64), dtype=torch.uint8, device="cuda")
    planes = torch.zeros((1, 64, 8), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="int8"):
        bsm.bitserial_matmul(x, planes, (0,))
    with pytest.raises(ValueError, match="contiguous"):
        aq.act_quant(torch.randn((64, 4), device="cuda").T)


def test_reduced_engine_serves_through_the_kernels(gen):
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    params = model.init(gen, device="cuda")
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, size=5 + i)
                    .astype(np.int32), max_new_tokens=6,
                    tier=list(tiers)[i % 3]) for i in range(6)]
    outs = []
    for backend in ("cuda", "decomposed"):
        sched = uniform_schedule(tiers, backend=backend)
        eng = ServeEngine(model, params, Runtime(policy=sched.policy_for(),
                                                 schedule=sched),
                          max_batch=4, max_len=32)
        _build.reset_launches()
        outs.append(eng.run(reqs))
        if backend == "cuda":
            assert all(v > 0 for v in _build.LAUNCHES.values()), \
                _build.LAUNCHES
        else:                               # the plain reference launches none
            assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert outs[0] == outs[1]
