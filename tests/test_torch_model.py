"""repro_torch model held against the JAX package on the reduced qwen3-8b:
configs, KV-cache codes and scales (EXACT, given the same K/V), weight
conversion and the prepared plane stores (EXACT), and logits of prefill
and decode steps on converted weights — EXACT against the reference run
op by op, CLOSE against the reference under ``jit``.

Why the jitted reference is only close: XLA:CPU keeps bf16 intermediates
in f32 across fused ops (``xla_allow_excess_precision``, on by default), so
the jitted reference skips roundings its source writes (``astype(bf16)``
before the next op).  The port rounds where the source casts, which is
exactly what the reference computes op by op.  The skipped roundings move
some 8-bit activation codes by one step, and the logits by a few bf16 ulps
(measured max 0.04 on |logit| <= 2); ATOL_JIT allows 2.5x that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.core.policy import uniform_policy as juniform_policy
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.models import layers as jlayers
from repro.models.layers import Runtime as JRuntime
from repro.models.transformer import LM as JLM
from repro.serve.engine import prepare_params as jprepare
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import convert_params, to_torch
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import prepare_params

ATOL_JIT = 0.1


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def models():
    jm = JLM(jreduced("qwen3-8b"))
    jp = jm.init(jax.random.PRNGKey(0))
    m = LM(reduced_config("qwen3-8b"))
    tp = convert_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, tp


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_mirror_the_reference(name):
    for j, t in ((JARCHS[name], ARCHS[name]), (jreduced(name),
                                               reduced_config(name))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.padded_vocab == j.padded_vocab
        assert t.period_pattern() == j.period_pattern()
    assert ARCHS[name].dtype == torch.bfloat16


def test_convert_unstacks_periods_bit_exact(models):
    jm, jp, m, tp = models
    assert len(tp["layers"]) == jm.cfg.n_periods
    for i in range(jm.cfg.n_periods):
        a = np.asarray(jp["periods"]["pos0"]["attn"]["q_proj"]["w"][i])
        b = tp["layers"][i]["pos0"]["attn"]["q_proj"]["w"]
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(np.uint16), _np(b))
    np.testing.assert_array_equal(
        np.asarray(jp["embed"]["emb"]).view(np.uint16),
        _np(tp["embed"]["emb"]))


@pytest.mark.parametrize("superplane", [True, False])
def test_prepared_stores_match_converted_reference(models, superplane):
    """prepare_params in the port == the reference's prepared store,
    converted (planes and scales bit-equal, every projection)."""
    jm, jp, m, tp = models
    jpol = juniform_policy(4, 8, backend="decomposed")
    pol = uniform_policy(4, 8, backend="decomposed")
    jprep_np = jax.tree.map(np.asarray,
                            jprepare(jp, jpol, jm, superplane=superplane)[0])
    want = convert_params(jprep_np, device="cpu")
    got, paths = prepare_params(tp, pol, m, superplane=superplane)
    assert len(paths) == 7 * jm.cfg.n_periods + 1
    n = 0
    for i, layer in enumerate(got["layers"]):
        for blk in ("attn", "mlp"):
            for proj, leaf in layer["pos0"][blk].items():
                if not isinstance(leaf.get("w"), tops.QuantizedWeight):
                    continue
                ref = want["layers"][i]["pos0"][blk][proj]["w"]
                assert leaf["w"].msb_first == ref.msb_first == superplane
                assert torch.equal(leaf["w"].planes, ref.planes)
                assert torch.equal(leaf["w"].scale, ref.scale)
                n += 1
    assert n == 7 * jm.cfg.n_periods
    assert torch.equal(got["lm_head"]["w"].planes, want["lm_head"]["w"].planes)


def test_kv_int8_codes_follow_the_jitted_reference():
    """KV int8 codes and scales equal the JITTED reference (reciprocal-
    multiply scale) — not the eager one, which divides."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 64, 2, 16)),
                    jnp.bfloat16)
    qj, sj = jax.jit(lambda a: jlayers._kv_quant(a, 8, jnp.bfloat16))(x)
    qt, st = tlayers._kv_quant(to_torch(np.asarray(x), "cpu"), 8,
                               torch.bfloat16)
    np.testing.assert_array_equal(_ref(qj), _np(qt))
    np.testing.assert_array_equal(_ref(sj), _np(st))


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_kv_cache_update_append_read_exact(kv_bits):
    rng = np.random.default_rng(1)
    b, s, kvh, dh = 3, 16, 2, 16
    k = jnp.asarray(rng.normal(size=(b, 6, kvh, dh)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(b, 6, kvh, dh)), jnp.bfloat16)
    k1 = jnp.asarray(rng.normal(size=(b, 1, kvh, dh)), jnp.bfloat16)
    v1 = jnp.asarray(rng.normal(size=(b, 1, kvh, dh)), jnp.bfloat16)
    lens = jnp.asarray([6, 3, 5], jnp.int32)
    active = jnp.asarray([True, False, True])

    def jrun(k, v, k1, v1):
        c = jlayers.KVCache.create(b, s, kvh, dh, kv_bits=kv_bits)
        c = c.update(k, v, 0, new_length=lens).append(k1, v1, active=active)
        return c, c.read(jnp.bfloat16)

    jc, (jk, jv) = jax.jit(jrun)(k, v, k1, v1)
    tc = tlayers.KVCache.create(b, s, kvh, dh, kv_bits=kv_bits, device="cpu")
    cv = lambda a: to_torch(np.asarray(a), "cpu")   # noqa: E731
    tc.update(cv(k), cv(v), 0, new_length=cv(lens))
    tc.append(cv(k1), cv(v1), active=cv(active))
    tk, tv = tc.read(torch.bfloat16)
    for a, t in ((jc.k, tc.k), (jc.v, tc.v), (jc.length, tc.length),
                 (jk, tk), (jv, tv)):
        np.testing.assert_array_equal(_ref(a), _np(t))
    if kv_bits == 8:
        np.testing.assert_array_equal(_ref(jc.k_scale), _np(tc.k_scale))
        np.testing.assert_array_equal(_ref(jc.v_scale), _np(tc.v_scale))


def test_layer_functions_exact():
    """rmsnorm / qk_headnorm / rope / attention on the same bf16 inputs."""
    rng = np.random.default_rng(2)
    cv = lambda a: to_torch(np.asarray(a), "cpu")   # noqa: E731
    x = jnp.asarray(rng.normal(size=(2, 12, 64)), jnp.bfloat16)
    g = {"g": jnp.asarray(rng.normal(size=(64,)), jnp.bfloat16)}
    np.testing.assert_array_equal(
        _ref(jax.jit(jlayers.rmsnorm)(g, x)),
        _np(tlayers.rmsnorm({"g": cv(g["g"])}, cv(x))))
    h = jnp.asarray(rng.normal(size=(2, 12, 4, 16)), jnp.bfloat16)
    gh = {"g": jnp.asarray(rng.normal(size=(16,)), jnp.bfloat16)}
    np.testing.assert_array_equal(
        _ref(jax.jit(jlayers.qk_headnorm)(gh, h)),
        _np(tlayers.qk_headnorm({"g": cv(gh["g"])}, cv(h))))
    pos = jnp.broadcast_to(jnp.arange(3, 15)[None], (2, 12))
    np.testing.assert_array_equal(
        _ref(jax.jit(lambda a, p: jlayers.rope(a, p, 1e4))(h, pos)),
        _np(tlayers.rope(cv(h), cv(pos), 1e4)))
    k = jnp.asarray(rng.normal(size=(2, 40, 1, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(2, 40, 1, 16)), jnp.bfloat16)
    for blk in (1024, 16):
        np.testing.assert_array_equal(
            _ref(jax.jit(lambda a, b, c: jlayers.flash_attention(
                a, b, c, block_k=blk, q_offset=3))(h, k, v)),
            _np(tlayers.flash_attention(cv(h), cv(k), cv(v), block_k=blk,
                                        q_offset=3)))
    jc = jlayers.KVCache.create(2, 40, 1, 16).update(
        k, v, 0, new_length=jnp.asarray([17, 40]))
    tc = tlayers.KVCache.create(2, 40, 1, 16, device="cpu")
    tc.update(cv(k), cv(v), 0, new_length=torch.tensor([17, 40]))
    np.testing.assert_array_equal(
        _ref(jax.jit(jlayers.decode_attention)(h[:, :1], jc)),
        _np(tlayers.decode_attention(cv(h[:, :1]), tc)))


def _logits(models, policy_pair, rt_pair, steps=2):
    """Prefill a right-padded batch, then greedy decode; logits per call
    from the port, the reference op by op, and the reference under jit."""
    jm, jp, m, tp = models
    (jpol, pol), (jrt, rt) = policy_pair, rt_pair
    jpp = jprepare(jp, jpol, jm)[0]
    tpp = prepare_params(tp, pol, m)[0]
    toks = np.random.default_rng(3).integers(0, 512, size=(2, 12)).astype(
        np.int32)
    lens = np.asarray([12, 9], np.int32)
    jpre = lambda p, c, t, l: jm.prefill(p, jrt, c, tokens=t,  # noqa: E731
                                         seq_lengths=l)
    jdec = lambda p, c, t: jm.decode_step(p, jrt, c, tokens=t)  # noqa: E731
    out = {"port": [], "eager": [], "jit": []}
    tc = m.init_cache(2, 32, device="cpu")
    tl, _ = m.prefill(tpp, rt, tc, tokens=torch.from_numpy(toks),
                      seq_lengths=torch.from_numpy(lens))
    out["port"].append(tl)
    with jax.disable_jit():
        el, ec = jpre(jpp, jm.init_cache(2, 32), jnp.asarray(toks),
                      jnp.asarray(lens))
    jl, jc = jax.jit(jpre)(jpp, jm.init_cache(2, 32), jnp.asarray(toks),
                           jnp.asarray(lens))
    out["eager"].append(el)
    out["jit"].append(jl)
    for _ in range(steps):
        nxt = torch.argmax(out["port"][-1][:, -1], dim=-1).to(torch.int32)
        tl, _ = m.decode_step(tpp, rt, tc, tokens=nxt[:, None])
        t = jnp.asarray(nxt.numpy()[:, None])
        with jax.disable_jit():
            el, ec = jdec(jpp, ec, t)
        jl, jc = jax.jit(jdec)(jpp, jc, t)
        out["port"].append(tl)
        out["eager"].append(el)
        out["jit"].append(jl)
    return out


@pytest.mark.parametrize("backend", ["decomposed", "cuda"])
def test_logits_exact_vs_eager_close_vs_jit(models, backend):
    # The reference's pallas backend equals its decomposed one bit for bit
    # (its own tests); op by op, decomposed is the one that runs quickly.
    pols = (juniform_policy(8, 8, backend="decomposed"),
            uniform_policy(8, 8, backend=backend))
    rts = (JRuntime(policy=pols[0], mode="serve"), Runtime(policy=pols[1]))
    out = _logits(models, pols, rts)
    for t, e, j in zip(out["port"], out["eager"], out["jit"]):
        assert t.shape == e.shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_ref(e), _np(t))
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   t.float().numpy(), rtol=0, atol=ATOL_JIT)


def test_logits_superplane_tiers_exact_vs_eager(models):
    """One-tier runtimes of a superplane schedule, at the widths the w8a8
    test above does not cover (plane prefixes of the 8-bit store)."""
    jm, jp, m, tp = models
    tiers = {"4/4": (4, 4), "2/2": (2, 2)}
    js = juniform_schedule(tiers, backend="decomposed")
    ts = uniform_schedule(tiers, backend="cuda")
    jsp = jprepare(jp, js.prepare_policy(), jm, superplane=True)[0]
    tsp = prepare_params(tp, ts.prepare_policy(), m, superplane=True)[0]
    toks = np.random.default_rng(3).integers(0, 512, size=(2, 12)).astype(
        np.int32)
    for tier in tiers:
        jrt = JRuntime(policy=js.policy_for(), mode="serve", schedule=js,
                       tier=tier)
        rt = Runtime(policy=ts.policy_for(), schedule=ts, tier=tier)
        with jax.disable_jit():
            el, _ = jm.prefill(jsp, jrt, jm.init_cache(2, 32),
                               tokens=jnp.asarray(toks))
        tl, _ = m.prefill(tsp, rt, m.init_cache(2, 32, device="cpu"),
                          tokens=torch.from_numpy(toks))
        np.testing.assert_array_equal(_ref(el), _np(tl))


def test_forward_matches_prefill_last_position(models):
    jm, jp, m, tp = models
    pol = uniform_policy(8, 8, backend="cuda")
    tpp = prepare_params(tp, pol, m)[0]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, size=(2, 7)).astype(np.int32))
    full, aux = m.forward(tpp, Runtime(policy=pol), toks)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    last, _ = m.prefill(tpp, Runtime(policy=pol),
                        m.init_cache(2, 16, device="cpu"), tokens=toks)
    assert full.shape == (2, 7, m.cfg.padded_vocab)
    assert torch.isfinite(full.float()).all()
    assert torch.equal(full[:, -1:], last)


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_each_projection_input_is_quantized_once(models, backend,
                                                 monkeypatch):
    """q/k/v share one activation quantization and gate/up another, so a
    layer quantizes 4 inputs (+1 for lm_head); ``decomposed`` takes the
    plain version and never calls the kernel wrapper."""
    jm, jp, m, tp = models
    pol = uniform_policy(8, 8, backend=backend)
    tpp = prepare_params(tp, pol, m)[0]
    calls = {"wrapper": 0, "plain": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tops.act_quant_kernel, "act_quant",
                        counted("wrapper", tops.act_quant_kernel.act_quant))
    monkeypatch.setattr(tops.ref, "act_quant_ref",
                        counted("plain", tops.ref.act_quant_ref))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, size=(2, 5)).astype(np.int32))
    rt = Runtime(policy=pol)
    cache = m.init_cache(2, 16, device="cpu")
    logits, _ = m.prefill(tpp, rt, cache, tokens=toks)
    m.decode_step(tpp, rt, cache, tokens=torch.argmax(
        logits[:, -1], dim=-1).to(torch.int32)[:, None])
    per_call = 4 * m.cfg.num_layers + 1
    assert calls == {"wrapper": 2 * per_call if backend == "cuda" else 0,
                     "plain": 2 * per_call}
