"""repro_torch's Mamba2 / SSD block held against the JAX package's on the
reduced mamba2-1.3b (d_model 64, 8 heads of 16, state 16, chunk 8), same
numpy-seeded inputs, the reference's weights converted.

The reference runs op by op (``jax.disable_jit``), so it rounds where its
source casts, as the port does.  The projections run the ``dense``
backend (bf16 matmuls accumulated in f32: the integer backends' exactness
is held elsewhere), so what differs is float arithmetic: the same
contractions summed in another order (a 3-operand einsum, a matmul
split).  Hence:

* the scan pieces on the same inputs agree to a relative 1e-5
  (``_causal_conv``, ``_decode_core``; measured 4.9e-6) or 1e-4 (the
  chunked scan and the final state, whose 3-operand contraction sums in
  another order; measured 1.2e-4 relative at worst on a value of
  magnitude 5e-3, so ``atol`` 1e-5 covers it);
* whole-block outputs pass the conv and SSD results through bf16 and an
  bf16 projection, so one f32 ulp may move a bf16 rounding by one step;
  they agree to ``ATOL_BLOCK`` (measured 9.8e-4: one bf16 ulp of a value
  near 0.25), the conv windows exactly and the states to 1e-4.

A padded prefill of prompts of 2, 5 and 8 tokens plus one of 13 (above
the chunk of 8) runs the conv window shorter than ``W - 1``, right padding
and the multi-chunk scan.
Within the port, each verify-window position equals its decode step bit
for bit.

Served: the streams of the reduced mamba2 (five requests over the three
tiers, admitted as slots free) and jamba (three requests, one per tier)
equal the reference engine's (its one subprocess, see
``_torch_reference.py``), for the kernel wrappers and the plain backend;
and continuous batching equals ``BatchServeEngine(max_batch=1)`` on both
stacks (the twin of the reference's
``test_engine_ssm_archs_match_reference``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (TIERS, reference_arch_runs, reference_weights,
                              to_requests)
from repro.configs import reduced_config as jreduced
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import ssm as jssm
from repro.models.layers import Runtime as JRuntime
from repro_torch.configs import reduced_config
from repro_torch.convert import to_torch
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import BatchServeEngine, ServeEngine
from repro_torch.serve.request import Request

RTOL_F32, ATOL_F32 = 1e-5, 1e-6
ATOL_BLOCK = 4e-3
LENGTHS = (2, 5, 8, 13)
ARCH = "mamba2-1.3b"


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(want, got, rtol=RTOL_F32, atol=ATOL_F32, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def block():
    """(reference cfg, reference params, port cfg, port params, runtimes)."""
    jcfg = jreduced(ARCH)
    jp = jssm.ssm_init(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree.map(lambda a: _t(a), jp)
    jrt = JRuntime(policy=juniform_policy(8, 8, backend="dense"),
                   mode="serve")
    rt = Runtime(policy=uniform_policy(8, 8, backend="dense"))
    return jcfg, jp, reduced_config(ARCH), tp, jrt, rt


def _x(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(b, s, d)), jnp.bfloat16)


def _jcache(jcfg, b):
    return jssm.SSMCache.create(b, jcfg)


def _tcache(cfg, b):
    return tssm.SSMCache.create(b, cfg, device="cpu")


# ------------------------------------------------------------ scan pieces
def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-40, 40, 801, dtype=np.float32),
                        np.asarray([-100.0, 100.0, 0.0], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    # atol: torch's exp on the CPU gives 0 where the result is subnormal
    # (softplus(-100) = 3.7e-44 in the reference).
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-38)
    # Above 20, torch's F.softplus returns x itself; logaddexp does not.
    assert got[-2] == want[-2] == np.float32(100.0)


@pytest.mark.parametrize("length", [5, 13])
def test_scan_pieces_close(block, length):
    jcfg, jp, cfg, tp, _, _ = block
    rng = np.random.default_rng(length)
    b, h, p, n = 2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    c = cfg.d_inner + 2 * n
    xin = jnp.asarray(rng.normal(size=(b, length, c)), jnp.bfloat16)
    _close(jssm._causal_conv(xin, jp["conv_w"], jp["conv_b"]),
           tssm._causal_conv(_t(xin), tp["conv_w"], tp["conv_b"]),
           what="causal conv")
    xh = jnp.asarray(rng.normal(size=(b, length, h, p)), jnp.bfloat16)
    dt = jnp.asarray(rng.uniform(0.0, 0.3, size=(b, length, h)), jnp.float32)
    bm, cm = (jnp.asarray(rng.normal(size=(b, length, n)), jnp.bfloat16)
              for _ in range(2))
    a = -jnp.exp(jp["A_log"])
    with jax.disable_jit():
        want = jssm._ssd_chunked(xh, dt, a, bm, cm, jp["D"], jcfg.ssm_chunk)
        want_s = jssm._final_state(xh, dt, a, bm)
    got = tssm._ssd_chunked(_t(xh), _t(dt), _t(a), _t(bm), _t(cm), tp["D"],
                            cfg.ssm_chunk)
    _close(want, got, rtol=1e-4, atol=1e-5, what="ssd chunked")
    _close(want_s, tssm._final_state(_t(xh), _t(dt), _t(a), _t(bm)),
           rtol=1e-4, atol=1e-5, what="final state")


def test_decode_core_close(block):
    jcfg, jp, cfg, tp, _, _ = block
    rng = np.random.default_rng(11)
    b, c = 3, cfg.d_inner + 2 * cfg.ssm_state
    conv = jnp.asarray(rng.normal(size=(b, cfg.ssm_conv - 1, c)), jnp.float32)
    conv = conv.astype(jnp.bfloat16).astype(jnp.float32)
    state = jnp.asarray(rng.normal(size=(b, cfg.ssm_heads, cfg.ssm_state,
                                         cfg.ssm_headdim)), jnp.float32)
    x_t = jnp.asarray(rng.normal(size=(b, 1, c)), jnp.bfloat16)
    dtp = jnp.asarray(rng.uniform(0.0, 0.3, size=(b, cfg.ssm_heads)),
                      jnp.float32)
    active = np.asarray([True, False, True])
    a = -jnp.exp(jp["A_log"])
    with jax.disable_jit():
        want = jssm._decode_core(jp, jcfg, conv, state, x_t, dtp, a,
                                 jnp.asarray(active))
    got = tssm._decode_core(tp, cfg, _t(conv), _t(state), _t(x_t), _t(dtp),
                            _t(a), torch.from_numpy(active))
    for w, g, what in zip(want, got, ("y", "conv", "state")):
        _close(w, g, what=what)
    # Inactive rows keep their cache bit for bit.
    np.testing.assert_array_equal(_f32(got[1])[1], np.asarray(conv)[1])
    np.testing.assert_array_equal(_f32(got[2])[1], np.asarray(state)[1])


# ------------------------------------------------------------- the block
@pytest.mark.parametrize("length", [2, 13])
def test_full_sequence_close(block, length):
    jcfg, jp, cfg, tp, jrt, rt = block
    x = _x(2, length, cfg.d_model, 20 + length)
    with jax.disable_jit():
        want, _ = jssm.ssm_apply(jp, x, jrt, jcfg, "layers.pos0.mamba")
    got, cache = tssm.ssm_apply(tp, _t(x), rt, cfg, "layers.pos0.mamba")
    assert cache is None and got.dtype == torch.bfloat16
    _close(want, got, rtol=0, atol=ATOL_BLOCK)


@pytest.fixture(scope="module")
def prefilled(block):
    """One right-padded prefill of four rows (LENGTHS, padded to 16) in
    both packages: (reference y and cache, port y and cache, x)."""
    jcfg, jp, cfg, tp, jrt, rt = block
    b, s = len(LENGTHS), 16
    x = _x(b, s, cfg.d_model, 31)
    lens = np.asarray(LENGTHS, np.int32)
    with jax.disable_jit():
        jy, jc = jssm.ssm_apply(jp, x, jrt, jcfg, "layers.pos0.mamba",
                                cache=_jcache(jcfg, b),
                                seq_lengths=jnp.asarray(lens))
    tc = _tcache(cfg, b)
    ty, tc2 = tssm.ssm_apply(tp, _t(x), rt, cfg, "layers.pos0.mamba",
                             cache=tc, seq_lengths=torch.from_numpy(lens))
    assert tc2 is tc
    return jy, jc, ty, tc, lens


def test_padded_prefill_close(block, prefilled):
    jy, jc, ty, tc, lens = prefilled
    for i, n in enumerate(lens):
        _close(jy[i, :n], ty[i, :n], rtol=0, atol=ATOL_BLOCK,
               what=f"row {i}")
    _close(jc.conv, tc.conv, what="conv")
    _close(jc.state, tc.state, rtol=1e-4, atol=1e-5, what="state")


def test_padded_prefill_equals_unpadded(block, prefilled):
    """Right padding changes nothing: each row's cache equals the cache of
    a prefill of that row alone, unpadded (port)."""
    _, _, cfg, tp, _, rt = block
    _, _, _, tc, lens = prefilled
    x = _t(_x(len(lens), 16, cfg.d_model, 31))
    for i, n in enumerate(lens):
        one = _tcache(cfg, 1)
        tssm.ssm_apply(tp, x[i:i + 1, :n], rt, cfg, "layers.pos0.mamba",
                       cache=one)
        _close(one.conv[0], tc.conv[i], rtol=0, atol=0, what=f"conv {i}")
        _close(one.state[0], tc.state[i], rtol=1e-5, atol=1e-6,
               what=f"state {i}")


def _caches_from(prefilled):
    jy, jc, ty, tc, lens = prefilled
    return (jssm.SSMCache(jc.conv, jc.state),
            tssm.SSMCache(tc.conv.clone(), tc.state.clone()))


def test_decode_step_close(block, prefilled):
    jcfg, jp, cfg, tp, jrt, rt = block
    jc, tc = _caches_from(prefilled)
    x = _x(len(LENGTHS), 1, cfg.d_model, 41)
    active = np.asarray([True, True, False, True])
    with jax.disable_jit():
        jy, jc2 = jssm.ssm_apply(jp, x, jrt, jcfg, "layers.pos0.mamba",
                                 cache=jc, active=jnp.asarray(active))
    before = [t.clone() for t in tc.tensors()]
    ty, tc2 = tssm.ssm_apply(tp, _t(x), rt, cfg, "layers.pos0.mamba",
                             cache=tc, active=torch.from_numpy(active))
    assert tc2 is tc                        # written in place
    for i in np.flatnonzero(active):
        _close(jy[i], ty[i], rtol=0, atol=ATOL_BLOCK, what=f"y {i}")
    _close(jc2.conv, tc.conv, what="conv")
    _close(jc2.state, tc.state, rtol=1e-4, atol=1e-5, what="state")
    for t, old in zip(tc.tensors(), before):
        assert torch.equal(t[2], old[2])    # the inactive row is untouched


def test_verify_window_close_and_equal_to_decode_steps(block, prefilled):
    """A 3-token verify window: per-step stacked caches close to the
    reference's, the arena cache untouched, and each position bit-equal
    to the sequential decode step it stands for."""
    jcfg, jp, cfg, tp, jrt, rt = block
    jc, tc = _caches_from(prefilled)
    w = 3
    x = _x(len(LENGTHS), w, cfg.d_model, 51)
    active = np.asarray([True, False, True, True])
    with jax.disable_jit():
        jy, jst = jssm.ssm_apply(jp, x, jrt, jcfg, "layers.pos0.mamba",
                                 cache=jc, active=jnp.asarray(active),
                                 verify_window=True)
    before = [t.clone() for t in tc.tensors()]
    ty, tst = tssm.ssm_apply(tp, _t(x), rt, cfg, "layers.pos0.mamba",
                             cache=tc, active=torch.from_numpy(active),
                             verify_window=True)
    for t, old in zip(tc.tensors(), before):
        assert torch.equal(t, old)          # the verify writes nothing
    assert tst.conv.shape == (w,) + tuple(tc.conv.shape)
    assert tst.state.shape == (w,) + tuple(tc.state.shape)
    for i in np.flatnonzero(active):
        _close(jy[i], ty[i], rtol=0, atol=ATOL_BLOCK, what=f"y {i}")
    _close(jst.conv, tst.conv, what="stacked conv")
    _close(jst.state, tst.state, rtol=1e-4, atol=1e-5, what="stacked state")
    # Sequential decode steps in the port: bit-equal, position by position.
    seq = tssm.SSMCache(before[0].clone(), before[1].clone())
    xt = _t(x)
    for j in range(w):
        yj, _ = tssm.ssm_apply(tp, xt[:, j:j + 1].contiguous(), rt, cfg,
                               "layers.pos0.mamba", cache=seq,
                               active=torch.from_numpy(active))
        assert torch.equal(yj[:, 0], ty[:, j]), j
        assert torch.equal(seq.conv, tst.conv[j]), j
        assert torch.equal(seq.state, tst.state[j]), j


# ---------------------------------------------------------------- serving
SERVE_KW = dict(max_batch=4, max_len=32, decode_chunk=4)


def _serve_specs(n, budget):
    rng = np.random.default_rng(1)
    return [{"uid": i, "prompt": rng.integers(0, 512, size=3 + (2 * i) % 6)
             .tolist(), "max_new": budget(i), "tier": list(TIERS)[i % 3]}
            for i in range(n)]


SERVE_RUNS = {"mamba2-1.3b": _serve_specs(5, lambda i: 4 + (3 * i) % 5),
              "jamba-1.5-large-398b": _serve_specs(3, lambda i: 5)}


@pytest.fixture(scope="module")
def reference_serve():
    """The reference engine's streams of ``SERVE_RUNS`` (one subprocess)
    and the checksums of the weights it served."""
    runs, sums = reference_arch_runs(SERVE_KW, [
        {"arch": a, "requests": specs} for a, specs in SERVE_RUNS.items()])
    return dict(zip(SERVE_RUNS, runs)), sums


@functools.lru_cache(maxsize=None)
def _converted(arch):
    _, _, checksum, params = reference_weights(arch)
    return checksum, params


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
@pytest.mark.parametrize("arch", list(SERVE_RUNS))
def test_streams_equal_reference_engine(reference_serve, arch, backend):
    streams, sums = reference_serve
    checksum, params = _converted(arch)
    assert checksum == sums[arch]
    sched = uniform_schedule(TIERS, backend=backend)
    eng = ServeEngine(LM(reduced_config(arch)), params,
                      Runtime(policy=sched.policy_for(), schedule=sched),
                      device="cpu", **SERVE_KW)
    assert eng.run(to_requests(SERVE_RUNS[arch])) == streams[arch]
    assert eng.stats.mixed_tier_chunks > 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mamba2-1.3b"])
def test_engine_ssm_archs_match_batch_engine(arch):
    """Masked SSM state and conv updates keep each request's stream equal
    to a batch-of-one run (dense backend, dropless MoE, as the reference's
    test)."""
    m = LM(reduced_config(arch))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = m.init(gen, device="cpu")
    rt = Runtime(policy=uniform_policy(8, 8, backend="dense"),
                 moe_dropless=True)
    rng = np.random.default_rng(9)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, size=2 + 3 * (i % 3))
                    .astype(np.int32), max_new_tokens=1 + 2 * (i % 3))
            for i in range(4)]
    got = ServeEngine(m, params, rt, max_batch=2, max_len=64, decode_chunk=3,
                      device="cpu").run(reqs)
    want = BatchServeEngine(m, params, rt, max_batch=1, max_len=64,
                            device="cpu").run(reqs)
    assert got == want


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b",
                                  "llama4-scout-17b-a16e"])
def test_decode_matches_full_forward(arch):
    """The twin of the reference's test of the same name, in the port:
    prefill's last logits equal the full forward's at that position
    within 1e-3, the next decode step's within 3e-2 (decode runs the O(1)
    recurrence on bf16 operands, the forward the f32-heavy chunked scan;
    the reference's own bounds), dense backend, dropless MoE."""
    m = LM(reduced_config(arch))
    gen = torch.Generator()
    gen.manual_seed(1)
    params = m.init(gen, device="cpu")
    rt = Runtime(policy=uniform_policy(8, 8, backend="dense"),
                 moe_dropless=True)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, size=(2, 12)).astype(np.int32))
    full = m.forward(params, rt, tokens)[0].to(torch.float32)
    caches = m.init_cache(2, 32, device="cpu")
    pre, _ = m.prefill(params, rt, caches, tokens[:, :-1])
    dec, _ = m.decode_step(params, rt, caches, tokens[:, -1:])
    np.testing.assert_allclose(pre[:, 0].float().numpy(),
                               full[:, -2].numpy(), atol=1e-3)
    np.testing.assert_allclose(dec[:, 0].float().numpy(),
                               full[:, -1].numpy(), atol=3e-2)
