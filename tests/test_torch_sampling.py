"""repro_torch.spec.sampling held against repro.spec.sampling and
jax.random.

* EXACT: request keys, ``fold_in`` subkeys, 32-bit random bits and f32
  uniforms (the threefry2x32 port and JAX's bits -> float conversion), the
  top-k threshold mask, greedy rows (argmax, ties to the first index) and
  the draw counters.
* CLOSE: the Gumbel noise ``-log(-log(u))`` and ``sampling_probs``: ``log``
  and ``softmax`` are the platform's own (XLA:CPU and torch differ in the
  last ulp), within ATOL_NOISE and PROBS_RTOL/PROBS_ATOL.
* Sampled tokens EQUAL to the reference's on these seeds, each decision's
  margin (the gap between the two best noisy scores) asserted above twice
  the noise gap, so an equal token is not luck.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.spec import sampling as js
from repro_torch.spec import sampling as ts

TINY = float(np.finfo(np.float32).tiny)
# Gumbel noise on the same uniforms, XLA against torch: measured max
# 9.5e-7 (one ulp of noise values up to ~16) on these inputs.
ATOL_NOISE = 4e-6
# sampling_probs against jax.nn.softmax: measured max abs 7.5e-9, max
# relative 2.4e-7, on these inputs.
PROBS_RTOL, PROBS_ATOL = 1e-6, 1e-8
VOCAB = 151936


def _key(seed):
    return torch.from_numpy(ts.request_key(seed).astype(np.int64))[None]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -1])
def test_keys_bits_uniforms_bit_equal(seed):
    kj = js.request_key(seed)
    np.testing.assert_array_equal(kj, ts.request_key(seed))
    np.testing.assert_array_equal(kj, np.asarray(jax.random.PRNGKey(seed)))
    for counter in (0, 1, 1000):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jnp.asarray(kj), counter)),
            ts.fold_in(_key(seed), torch.tensor([counter]))[0].numpy())
        for tag in (ts.TAG_TOKEN, ts.TAG_ACCEPT, ts.TAG_RESIDUAL):
            sub_j = js.fold_events(jnp.asarray(kj)[None],
                                   jnp.asarray([counter], jnp.int32), tag)
            sub_t = ts.fold_events(_key(seed), torch.tensor(
                [counter], dtype=torch.int32), tag)
            np.testing.assert_array_equal(np.asarray(sub_j), sub_t.numpy())
            for shape in ((), (1,), (5,), (VOCAB,)):
                n = int(np.prod(shape))
                bits = np.asarray(jax.random.bits(sub_j[0], shape))
                np.testing.assert_array_equal(
                    bits.reshape(-1), ts.random_bits(sub_t, n)[0].numpy())
                for lo in (0.0, TINY):
                    u = np.asarray(jax.random.uniform(
                        sub_j[0], shape, jnp.float32, minval=lo, maxval=1.0))
                    mine = ts.uniform(sub_t, n, minval=lo)[0].numpy()
                    np.testing.assert_array_equal(
                        u.reshape(-1).view(np.uint32), mine.view(np.uint32))


def test_request_key_wraps_like_prngkey():
    for seed in (2 ** 31, 2 ** 32 - 1, 2 ** 33 + 5, -2 ** 40 - 3):
        np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                      ts.request_key(seed))


def test_mask_top_k_exact_with_ties():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    x[1, :5] = x[1].max() + 1.0            # five tied maxima
    x[2, [3, 9, 17]] = np.sort(x[2])[-4]   # ties at the 4th value
    top_k = np.asarray([0, 3, 4, 1, 40, 55], np.int32)
    want = np.asarray(js.mask_top_k(jnp.asarray(x), jnp.asarray(top_k)))
    got = ts.mask_top_k(torch.from_numpy(x), torch.from_numpy(top_k)).numpy()
    np.testing.assert_array_equal(want, got)
    assert np.isfinite(got[1]).sum() == 5      # the tie is kept whole
    assert np.isfinite(got[2]).sum() == 6


def _state(b, seed=0):
    keys = np.stack([js.request_key(s) for s in range(seed, seed + b)])
    draws = np.arange(b, dtype=np.int32) * 3
    return keys, draws


def _sample_both(logits, keys, draws, temp, top_k, active=None):
    jt, jd = js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(draws),
        jnp.asarray(temp), jnp.asarray(top_k),
        None if active is None else jnp.asarray(active))
    cv = torch.from_numpy
    tt, td = ts.sample_tokens(
        cv(logits), cv(keys.astype(np.int64)), cv(draws), cv(temp),
        cv(top_k), None if active is None else cv(active))
    return (np.asarray(jt), np.asarray(jd)), (tt.numpy(), td.numpy())


def test_greedy_rows_are_argmax_and_inactive_rows_hold_counters():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 300)).astype(np.float32)
    logits[0, [7, 11]] = 9.0                     # a tie: the first index
    temp = np.asarray([0.0, 0.0, 0.7, 1.0, 0.5], np.float32)
    top_k = np.asarray([0, 5, 0, 20, 3], np.int32)
    active = np.asarray([True, True, True, False, True])
    keys, draws = _state(5)
    (jt, jd), (tt, td) = _sample_both(logits, keys, draws, temp, top_k,
                                      active)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jd, td)
    assert tt[0] == 7 and tt[1] == logits[1].argmax()
    # Counters advance for active sampled rows only.
    np.testing.assert_array_equal(td - draws, [0, 0, 1, 0, 1])
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    tok, _ = ts.sample_tokens(bf, torch.from_numpy(keys.astype(np.int64)),
                              torch.from_numpy(draws), torch.zeros(5),
                              torch.zeros(5, dtype=torch.int32))
    assert torch.equal(tok, torch.argmax(bf, dim=-1).to(torch.int32))


@pytest.mark.parametrize("temp,top_k", [(0.8, 40), (1.0, 0), (0.3, 2)])
def test_sampled_tokens_equal_reference_with_margin(temp, top_k):
    """Full-vocabulary rows: tokens equal the reference's; the uniforms
    are bit-equal, the noise close, and every decision's margin exceeds
    twice the noise gap."""
    rng = np.random.default_rng(int(temp * 10) + top_k)
    b = 6
    logits = (rng.normal(size=(b, VOCAB)) * 3.0).astype(np.float32)
    keys, draws = _state(b, seed=100)
    temps = np.full((b,), temp, np.float32)
    ks = np.full((b,), top_k, np.int32)
    (jt, jd), (tt, td) = _sample_both(logits, keys, draws, temps, ks)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jd, td)
    sub = ts.fold_events(torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(draws), ts.TAG_TOKEN)
    u = ts.uniform(sub, VOCAB, minval=TINY)
    noise_t = -torch.log(-torch.log(u))
    noise_j = np.asarray(-jnp.log(-jnp.log(jnp.asarray(u.numpy()))))
    gap = float(np.abs(noise_t.numpy() - noise_j).max())
    assert gap <= ATOL_NOISE
    scores = ts.mask_top_k(ts.scale_logits(torch.from_numpy(logits),
                                           torch.from_numpy(temps)),
                           torch.from_numpy(ks)) + noise_t
    top2 = torch.topk(scores, 2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    assert margin > 2 * gap, (margin, gap)
    np.testing.assert_array_equal(tt, torch.argmax(scores, -1).numpy())


def test_sampling_probs_close():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(4, VOCAB)) * 2.0).astype(np.float32)
    temp = np.asarray([0.0, 0.8, 1.3, 0.5], np.float32)
    top_k = np.asarray([0, 40, 0, 1], np.int32)
    want = np.asarray(js.sampling_probs(jnp.asarray(logits),
                                        jnp.asarray(temp),
                                        jnp.asarray(top_k)))
    got = ts.sampling_probs(torch.from_numpy(logits), torch.from_numpy(temp),
                            torch.from_numpy(top_k)).numpy()
    np.testing.assert_array_equal(want[0], got[0])     # greedy point mass
    np.testing.assert_array_equal(want == 0, got == 0)  # same support
    np.testing.assert_allclose(want, got, rtol=PROBS_RTOL, atol=PROBS_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_sampling_params_validate():
    ts.SamplingParams(0.5, 3, 1).validate()
    with pytest.raises(ValueError, match="temperature"):
        ts.SamplingParams(temperature=-0.1).validate()
    with pytest.raises(ValueError, match="top_k"):
        ts.SamplingParams(top_k=-1).validate()
