"""repro_torch's MoE block held against the JAX package's on the reduced
llama4-scout (4 experts top-1, shared expert) and grok-1 (4 experts top-2;
jamba's reduced MoE layer is the same shape) configs, same numpy-seeded
inputs, the reference's weights converted.

* EXACT: the routing decisions (each token's experts ``top_i``), the
  capacity, ``keep`` and ``slot``; the expert-stacked superplane store
  (codes and scales, int8 planes and the packed store) against the
  reference's ``prepare_params``; ``quant_layer_macs`` and the parameter
  counts of all four SSM / hybrid / MoE archs; a zero expert row's
  activation codes and scale.
* CLOSE: router probabilities and weights (f32 matmul and softmax summed
  in another order: rtol 1e-6, measured 2.9e-7), the aux loss, and the
  block output ``y`` (the reference op by op with ``dense`` projections:
  bf16 matmuls accumulated in f32 and combined in f32, so a sum taken in
  another order may round to the neighbouring bf16 value: one bf16 ulp,
  ``RTOL_Y``; measured equal on every case here).

The routing decisions can only be exact if no top-k choice is a near tie:
the smallest gap between the k-th and (k+1)-th probability on these seeds
is 3.7e-5 (llama4, the dropless routing case), against a probability
error of at most 6.0e-8.
Within the port, a verify window's MoE positions equal the decode steps
they stand for, bit for bit.

Served: the reduced llama4's streams (four requests over the three tiers,
capacity dispatch in prefill) equal the reference engine's (its one
subprocess, see ``_torch_reference.py``) from both stores, and greedy
speculation equals plain decoding on it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (TIERS, reference_arch_runs, reference_weights,
                              to_requests)
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.core.policy import uniform_policy as juniform_policy
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.layers import Runtime as JRuntime
from repro.models.transformer import LM as JLM
from repro.serve.engine import prepare_params as jprepare
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import convert_params, to_torch
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine, prepare_params
from repro_torch.spec import SpecConfig

RTOL_Y, ATOL_Y = 2.0 ** -8, 1e-3
MOE_ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
NEW_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b") + MOE_ARCHS
# (batch, sequence, dropless): dropless serves every token; the capacity
# case's tokens share a common offset, so they crowd some experts and the
# capacity drops tokens.
SHAPES = {"dropless": (3, 7, True), "capacity": (2, 16, False)}


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def block(request):
    arch = request.param
    jcfg = jreduced(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jcfg)
    tp = jax.tree.map(_t, jp)
    return arch, jcfg, jp, reduced_config(arch), tp


def _x(b, s, d, seed, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d))
    if skew:
        x = x + 2.0 * rng.normal(size=(1, 1, d))
    return jnp.asarray(x, jnp.bfloat16)


def _reference_routing(jp, x, jcfg, dropless):
    """The reference's routing lines (``repro.models.moe.moe_apply``),
    run op by op: (probs, top_w, top_i, capacity, keep, slot, aux)."""
    b, s, _ = x.shape
    e, k = jcfg.num_experts, jcfg.experts_per_token
    with jax.disable_jit():
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            jp["router"]["w"])
        probs = jax.nn.softmax(logits, axis=-1)
        top_w, top_i = jax.lax.top_k(probs, k)
        top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
        density = jnp.mean(jax.nn.one_hot(top_i[..., 0], e,
                                          dtype=jnp.float32), axis=(0, 1))
        aux = e * jnp.sum(density * jnp.mean(probs, axis=(0, 1)))
        cap = s if dropless else int(max(1, round(
            s * k * jcfg.capacity_factor / e)))
        cap = min(cap, s)
        flat_e = top_i.reshape(b, s * k)
        onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=1) - onehot
        pos_in_e = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
        keep = pos_in_e < cap
        slot = jnp.where(keep, flat_e * cap + pos_in_e, e * cap)
    return probs, top_w, top_i, cap, keep, slot, aux


@pytest.mark.parametrize("case", list(SHAPES))
def test_routing_capacity_keep_slot_exact(block, case):
    arch, jcfg, jp, cfg, tp = block
    b, s, dropless = SHAPES[case]
    x = _x(b, s, cfg.d_model, 7 + s, skew=not dropless)
    probs, top_w, top_i, cap, keep, slot, aux = _reference_routing(
        jp, x, jcfg, dropless)
    tprobs, ttop_w, ttop_i = tmoe.route(tp, _t(x), cfg.experts_per_token)
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(top_i))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(ttop_w.numpy(), np.asarray(top_w), rtol=1e-6)
    np.testing.assert_allclose(float(tmoe.aux_loss(tprobs, ttop_i)),
                               float(aux), rtol=1e-6)
    assert tmoe.capacity(s, cfg, dropless) == cap
    tkeep, tslot = tmoe.dispatch_slots(ttop_i, cfg.num_experts, cap)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    assert bool(np.asarray(keep).all()) == dropless   # the capacity case drops
    # The decisions are not near ties (see the module docstring).
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    k = cfg.experts_per_token
    assert (srt[..., k - 1] - srt[..., k]).min() > 1e-5


def test_topk_ties_take_the_lower_expert():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25],
                           [0.1, 0.4, 0.1, 0.4]]])
    params = {"router": {"w": torch.eye(4)}}
    _, top_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    # Route the probabilities themselves: softmax of log(p) is p again.
    _, _, ti = tmoe.route(params, torch.log(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(top_i))
    assert ti.tolist() == [[[0, 1], [1, 3]]]


@pytest.mark.parametrize("case", list(SHAPES))
def test_moe_apply_close(block, case):
    arch, jcfg, jp, cfg, tp = block
    b, s, dropless = SHAPES[case]
    x = _x(b, s, cfg.d_model, 70 + s, skew=not dropless)
    jrt = JRuntime(policy=juniform_policy(8, 8, backend="dense"),
                   mode="serve", moe_dropless=dropless)
    rt = Runtime(policy=uniform_policy(8, 8, backend="dense"),
                 moe_dropless=dropless)
    with jax.disable_jit():
        want, _ = jmoe.moe_apply(jp, x, jrt, jcfg, "layers.pos0.moe")
    got, _ = tmoe.moe_apply(tp, _t(x), rt, cfg, "layers.pos0.moe")
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL_Y,
                               atol=ATOL_Y)


def test_verify_window_equals_decode_steps(block):
    """Integer projections, dropless window of 4: position j equals the
    decode call on token j alone (capacity 1), bit for bit."""
    arch, jcfg, jp, cfg, tp = block
    rt = Runtime(policy=uniform_policy(8, 8, backend="cuda"))
    x = _t(_x(3, 4, cfg.d_model, 91))
    win, _ = tmoe.moe_apply(tp, x, rt, cfg, "layers.pos0.moe",
                            verify_window=True)
    for j in range(x.shape[1]):
        step, _ = tmoe.moe_apply(tp, x[:, j:j + 1].contiguous(), rt, cfg,
                                 "layers.pos0.moe")
        assert torch.equal(step[:, 0], win[:, j]), j


def test_zero_expert_rows_quantize_as_the_reference():
    """A capacity buffer's empty rows: codes 0 and scale 1e-8 * (1/qmax),
    equal to the reference's, for both act-quant kernels' plain versions."""
    x = np.zeros((3, 64), np.float32)
    x[1] = np.linspace(-1, 1, 64)
    qmax = np.asarray([[127.0], [7.0], [1.0]], np.float32)
    jq, js = jref.act_quant_rows_ref(jnp.asarray(x), jnp.asarray(qmax))
    tq, ts = tref.act_quant_rows_ref(torch.from_numpy(x),
                                     torch.from_numpy(qmax))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = jref.act_quant_ref(jnp.asarray(x), bits=8)
    tq, ts = tref.act_quant_ref(torch.from_numpy(x), bits=8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[0].any() and not tq[2].any()


@pytest.mark.parametrize("packed", [False, True])
def test_expert_stacked_store_matches_reference(packed):
    """prepare_params on the reduced llama4 (routed and shared experts):
    the port's expert-stacked superplane store equals the reference's
    ``jax.vmap(prep)`` store, converted; the router and norms stay float;
    each expert's view is its slice."""
    arch = "llama4-scout-17b-a16e"
    jm = JLM(jreduced(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    m = LM(reduced_config(arch))
    tp = convert_params(jax.tree.map(np.asarray, jp), device="cpu")
    jpol = juniform_policy(8, 8, backend="decomposed")
    pol = uniform_policy(8, 8, backend="decomposed")
    want = convert_params(jax.tree.map(np.asarray, jprepare(
        jp, jpol, jm, superplane=True, packed=packed)[0]), device="cpu")
    got, paths = prepare_params(tp, pol, m, superplane=True, packed=packed)
    e = m.cfg.num_experts
    assert sum(p.endswith("moe.gate_proj.w") for p in paths) == \
        m.cfg.n_periods
    for i, layer in enumerate(got["layers"]):
        blk, ref = layer["pos0"]["moe"], want["layers"][i]["pos0"]["moe"]
        assert isinstance(blk["router"]["w"], torch.Tensor)
        assert torch.equal(blk["router"]["w"], ref["router"]["w"])
        for proj in ("gate_proj", "up_proj", "down_proj"):
            g, r = blk[proj]["w"], ref[proj]["w"]
            store = g.packed if packed else g.planes
            assert store.shape[0] == e and g.scale.shape[:2] == (e, 1)
            assert torch.equal(store, r.packed if packed else r.planes)
            assert torch.equal(g.scale, r.scale)
            assert g.msb_first and (g.w_bits, g.signed) == (r.w_bits, r.signed)
            for x in range(e):
                v = g.expert(x)
                assert v is g.expert(x)            # made once
                assert torch.equal(v.packed if packed else v.planes, store[x])
                assert torch.equal(v.scale, g.scale[x])
            sg, sr = blk["shared"][proj]["w"], ref["shared"][proj]["w"]
            assert torch.equal(sg.packed if packed else sg.planes,
                               sr.packed if packed else sr.planes)
            assert torch.equal(sg.scale, sr.scale)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cost_model_equals_reference(arch):
    for j, t in ((JARCHS[arch], ARCHS[arch]),
                 (jreduced(arch), reduced_config(arch))):
        assert t.quant_layer_macs() == j.quant_layer_macs()
        assert list(t.quant_layer_macs()) == list(j.quant_layer_macs())
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)


# ---------------------------------------------------------------- serving
SERVE_ARCH = "llama4-scout-17b-a16e"
SERVE_KW = dict(max_batch=3, max_len=32, decode_chunk=4)


def _serve_specs():
    rng = np.random.default_rng(2)
    return [{"uid": i, "prompt": rng.integers(0, 512, size=3 + 2 * i)
             .tolist(), "max_new": 5 + i % 2, "tier": list(TIERS)[i % 3]}
            for i in range(4)]


@pytest.fixture(scope="module")
def served():
    """The reference engine's streams (one subprocess), the converted
    weights and the port's engine factory."""
    (streams,), sums = reference_arch_runs(SERVE_KW, [
        {"arch": SERVE_ARCH, "requests": _serve_specs()}])
    _, _, checksum, params = reference_weights(SERVE_ARCH)
    assert checksum == sums[SERVE_ARCH]
    sched = uniform_schedule(TIERS, backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    model = LM(reduced_config(SERVE_ARCH))

    def engine(params=params, **kw):
        return ServeEngine(model, params, rt, device="cpu",
                           **{**SERVE_KW, **kw})
    return streams, engine


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_streams_equal_reference_engine(served, packed):
    streams, engine = served
    eng = engine(packed=packed)
    assert eng.run(to_requests(_serve_specs())) == streams
    store = eng.params["layers"][0]["pos0"]["moe"]["gate_proj"]["w"]
    assert (store.packed if packed else store.planes).shape[0] == 4
    assert eng.stats.mixed_tier_chunks > 0


def test_greedy_speculative_equals_plain(served):
    """Speculating MoE slots (dropless verify windows) beside plain ones:
    the streams equal plain decoding's."""
    streams, engine = served
    specs = _serve_specs()
    reqs = to_requests(specs)
    for r in reqs:
        if r.uid % 3 != 2:
            r.spec = SpecConfig("8/8" if r.uid % 3 == 0 else "2/2", 3)
    eng = engine()
    assert eng.run(reqs) == streams
    assert eng.stats.spec_rounds > 0 and eng.stats.spec_accepted > 0
