"""repro_torch self-speculative decoding held against the JAX package, and
the reference's speculative invariants re-asserted within the port.

* Acceptance (``spec.speculate``) on the same f32 distributions as
  ``repro.spec.speculate``: accept counts and greedy corrections EXACT,
  sampled corrections equal on these seeds with each draw's Gumbel margin
  asserted (``log`` is the platform's own, so the noise is only close).
* ``LM.verify_step``: window position j BIT-EQUAL to the j-th sequential
  ``decode_step`` (logits and the whole arena), for both weight stores,
  mixed-tier and one-tier layouts; CLOSE to the reference's ``verify_step``
  run op by op (ATOL_LOGITS).
* The arena after a round that rejects drafts: below each slot's length
  EQUAL to sequential greedy decoding; in whole (lanes past each length
  too) equal to the reference's own sequence — draft ``decode_step``s,
  ``slots.merge_slots``, ``LM.verify_step``, ``slots.truncate_kv_lengths``
  — run op by op: lengths exact, K/V codes and scales within ATOL_KV.
* ``ServeEngine``: greedy speculative streams == plain streams; greedy
  speculative and sampled streams equal to the reference engine's
  (subprocess, see _torch_reference.py); stats identities, event flags,
  no weight preparation after construction; submit and CLI errors.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import (ENGINE_KW, TIERS, reference_runs,
                              reference_weights, request_specs, to_requests)
from repro.core.policy import uniform_schedule as juniform_schedule
from repro.models.layers import Runtime as JRuntime
from repro.serve import slots as jslots
from repro.serve.engine import prepare_params as jprepare
from repro.spec import speculate as jspec
from repro_torch.configs import reduced_config
from repro_torch.core.policy import uniform_policy, uniform_schedule
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import KVCache, Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request
from repro_torch.spec import SamplingParams, SpecConfig
from repro_torch.spec import sampling as tsamp
from repro_torch.spec import speculate as tspec

# Logits of the port's verify window against the reference's op by op: the
# port equals the reference op by op elsewhere (test_torch_model.py); the
# measured gap here is 0, the bound allows a few bf16 ulps at |logit| <= 2.
ATOL_LOGITS = 0.05
# K/V entries (int8 codes and bf16 scales) against the reference's
# sequence, where the reference computes them in float: measured 0.
ATOL_KV = 0.0

TINY = float(np.finfo(np.float32).tiny)
B, MAX_LEN, K = 3, 32, 3
SLOT_TIERS = ("8/8", "4/4", "8/8")          # each slot's own (verify) tier
SPEC_MASK = (True, True, False)             # slots 0 and 1 speculate
DRAFT_TIER = "2/2"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(tiers):
    """(groups, perm) of a slot-tier vector, as ServeEngine._group_layout."""
    rank = {t: i for i, t in enumerate(TIERS)}
    order = sorted(range(len(tiers)), key=lambda s: (rank[tiers[s]], s))
    groups = []
    for s in order:
        if groups and groups[-1][0] == tiers[s]:
            groups[-1][1] += 1
        else:
            groups.append([tiers[s], 1])
    return tuple((t, n) for t, n in groups), np.asarray(order, np.int32)


DRAFT_TIERS = tuple(DRAFT_TIER if s else t
                    for t, s in zip(SLOT_TIERS, SPEC_MASK))


@pytest.fixture(scope="module")
def setup():
    """The reference's reduced qwen3-8b weights, its superplane store, and
    the port's superplane stores (int8 planes, packed) of the same weights."""
    jm, jp, _, tp = reference_weights()
    m = LM(reduced_config("qwen3-8b"))
    sched = uniform_schedule(TIERS, backend="cuda")
    stores = {packed: engine_mod.prepare_params(
        tp, sched.prepare_policy(), m, packed=packed, superplane=True)[0]
        for packed in (False, True)}
    jsched = juniform_schedule(TIERS, backend="decomposed")
    jstore = jprepare(jp, jsched.prepare_policy(), jm, superplane=True)[0]
    return {"jm": jm, "jstore": jstore, "jsched": jsched, "m": m,
            "sched": sched, "stores": stores, "params": tp}


def _prompts():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, size=(B, 8)).astype(np.int32)
    return toks, np.asarray([8, 5, 7], np.int32)


def _port_runtime(setup, tiers):
    groups, perm = _layout(tiers)
    rt = Runtime(policy=setup["sched"].policy_for(), schedule=setup["sched"])
    return rt.for_groups(groups, torch.from_numpy(perm.astype(np.int64)))


def _ref_runtime(setup, tiers):
    groups, perm = _layout(tiers)
    rt = JRuntime(policy=setup["jsched"].policy_for(), mode="serve",
                  schedule=setup["jsched"])
    return rt.for_groups(groups, jnp.asarray(perm))


def _port_prefill(setup, packed, kv_bits):
    m = setup["m"]
    caches = m.init_cache(B, MAX_LEN, kv_bits=kv_bits, device="cpu")
    toks, lens = _prompts()
    rt = Runtime(policy=setup["sched"].policy_for(), schedule=setup["sched"])
    logits, _ = m.prefill(setup["stores"][packed], rt.for_tier("8/8"), caches,
                          tokens=torch.from_numpy(toks),
                          seq_lengths=torch.from_numpy(lens))
    return caches, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _clone(caches):
    return [{pos: type(c)(*[None if t is None else t.clone()
                            for t in (getattr(c, f) for f in c.FIELDS)])
             for pos, c in layer.items()} for layer in caches]


def _arena(caches):
    """Every cache tensor of the arena, in a fixed order."""
    return [t for layer in caches for c in layer.values()
            for t in (c.k, c.v, c.k_scale, c.v_scale, c.length)
            if t is not None]


def _assert_arena_equal(a, b):
    for x, y in zip(_arena(a), _arena(b), strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------------------ acceptance
def _dists(rng, b, w, v, greedy_rows):
    """f32 distributions [b, w, v]: softmax of random logits with a few
    zeroed entries; ``greedy_rows`` are point masses."""
    logits = rng.normal(size=(b, w, v)) * 2.0
    logits[rng.random(size=logits.shape) < 0.2] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    for r in greedy_rows:
        p[r] = np.eye(v, dtype=np.float32)[p[r].argmax(-1)]
    return p


def test_acceptance_matches_reference():
    """accept_counts, correction_tokens and emission_window on the same
    distributions, keys and counters: counts, corrections and windows
    equal; the sampled rows' decisions have margins above 1e-4 (the
    distributions and noise agree with the reference's to ~1e-6, see
    test_torch_sampling.py), so the equality is not luck."""
    rng = np.random.default_rng(0)
    b, k, v = 6, 4, 64
    greedy = (0, 1)
    q = _dists(rng, b, k, v, greedy)
    p = _dists(rng, b, k + 1, v, greedy)
    drafts = np.stack([[rng.choice(v, p=q[r, j]) for j in range(k)]
                       for r in range(b)]).astype(np.int32)
    # Row 1 drafts the verify argmax where it can: a greedy accept.
    drafts[1] = p[1, :k].argmax(-1)
    keys = np.stack([[0, s] for s in (3, 7, 11, 13, 17, 19)]).astype(np.uint32)
    draws = np.asarray([0, 4, 9, 100, 1, 2], np.int32)
    jm_ = jspec.accept_counts(*map(jnp.asarray, (drafts, q, p, keys, draws)))
    cv = torch.from_numpy
    tkeys = cv(keys.astype(np.int64))
    tm = tspec.accept_counts(cv(drafts), cv(q), cv(p), tkeys, cv(draws))
    np.testing.assert_array_equal(np.asarray(jm_), tm.numpy())
    assert tm[1] == k and 0 < int(tm.sum()) < b * k
    jc = jspec.correction_tokens(jnp.asarray(q), jnp.asarray(p), jm_,
                                 jnp.asarray(keys), jnp.asarray(draws))
    tc = tspec.correction_tokens(cv(q), cv(p), tm, tkeys, cv(draws))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(
        np.asarray(jspec.emission_window(jnp.asarray(drafts), jc, jm_)),
        tspec.emission_window(cv(drafts), tc, tm).numpy())
    # Margins of the sampled rows' decisions: |u - min(ratio, 1)| of every
    # accept draw, and the gap between the two best noisy residual scores.
    sampled = slice(len(greedy), b)
    idx = cv(drafts).long()[..., None]
    ratio = (cv(p)[:, :k].gather(-1, idx) / cv(q).gather(-1, idx))[..., 0]
    u = tspec._per_position_uniform(
        tkeys, cv(draws)[:, None] + torch.arange(k, dtype=torch.int32),
        tsamp.TAG_ACCEPT)
    assert (u - ratio.clamp_max(1.0)).abs()[sampled].min() > 1e-4
    q_ext = torch.nn.functional.pad(cv(q), (0, 0, 0, 1))
    stop = tm.long()[:, None, None].expand(-1, 1, v)
    res = (cv(p).gather(1, stop) - q_ext.gather(1, stop))[:, 0].clamp_min(0)
    sub = tsamp.fold_events(tkeys, cv(draws), tsamp.TAG_RESIDUAL)
    noisy = torch.log(res / res.sum(-1, keepdim=True)) - torch.log(
        -torch.log(tsamp.uniform(sub, v, minval=TINY)))
    top2 = torch.topk(noisy[sampled], 2, dim=-1).values
    assert (top2[:, 0] - top2[:, 1]).min() > 1e-4
    assert tspec.accept_draw_events(k) == jspec.accept_draw_events(k) == k + 1


def test_spec_config_validates():
    SpecConfig("2/2", 1).validate()
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpecConfig("2/2", 0).validate()


# -------------------------------------------------------------- slots
def test_rollback_helpers_in_place():
    m = LM(reduced_config("qwen3-8b"))
    caches = m.init_cache(3, 8, kv_bits=8, device="cpu")
    for c in (c for layer in caches for c in layer.values()):
        c.length.copy_(torch.tensor([2, 3, 4], dtype=torch.int32))
    keep = torch.tensor([True, False, True])
    saved = slots_lib.pre_draft_state(caches, keep)
    for c in (c for layer in caches for c in layer.values()):
        c.length.add_(3)
    slots_lib.merge_slots(caches, saved, keep)
    assert caches[1]["pos0"].length.tolist() == [2, 6, 4]
    slots_lib.truncate_kv_lengths(caches, torch.tensor([1, 9, 1]),
                                  torch.tensor([False, True, True]))
    assert caches[0]["pos0"].length.tolist() == [2, 0, 3]
    # KV caches are the identity under select_verify_step.
    assert slots_lib.select_verify_step(caches, caches,
                                        torch.zeros(3)) is caches
    assert caches[0]["pos0"].length.tolist() == [2, 0, 3]
    # SSM rows: merge_slots gives the saved rows back to the kept slots;
    # select_verify_step writes each slot's step of the stacked states.
    hm = LM(reduced_config("jamba-1.5-large-398b"))
    hc = hm.init_cache(3, 8, device="cpu")
    ssm = hc[0]["pos0"]
    ssm.state.normal_()
    before = ssm.state.clone()
    saved = slots_lib.pre_draft_state(hc, keep)
    ssm.state.add_(1.0)
    slots_lib.merge_slots(hc, saved, keep)
    assert torch.equal(ssm.state[0], before[0])
    assert torch.equal(ssm.state[1], before[1] + 1.0)
    assert torch.equal(ssm.state[2], before[2])
    steps = [{pos: (type(c)(*(torch.stack([t + j for j in range(4)])
                              for t in c.tensors()))
                    if pos != "pos7" else c) for pos, c in layer.items()}
             for layer in hc]
    want = ssm.state + torch.tensor([3.0, 0.0, 2.0])[:, None, None, None]
    slots_lib.select_verify_step(hc, steps, torch.tensor([3, 0, 2]))
    assert torch.equal(ssm.state, want)


# ------------------------------------------------------------ verify_step
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tiers", ["mixed", "one-tier"])
def test_verify_positions_bit_equal_sequential_decode(setup, packed, tiers):
    """Every window position's logits and KV write equal the sequential
    decode step's, bit for bit, with plain rows inactive in both (their
    logits are never read: the verify places them at length + j)."""
    m, params = setup["m"], setup["stores"][packed]
    slot_tiers = SLOT_TIERS if tiers == "mixed" else ("8/8",) * B
    rt = _port_runtime(setup, slot_tiers)
    caches, tok0 = _port_prefill(setup, packed, kv_bits=None)
    rng = np.random.default_rng(5)
    window = torch.cat([tok0[:, None], torch.from_numpy(
        rng.integers(0, 512, size=(B, K)).astype(np.int32))], dim=1)
    active = torch.tensor(SPEC_MASK)
    seq = _clone(caches)
    vlogits, _ = m.verify_step(params, rt, caches, tokens=window,
                               active=active)
    assert vlogits.shape == (B, K + 1, m.cfg.padded_vocab)
    for j in range(K + 1):
        lj, _ = m.decode_step(params, rt, seq, tokens=window[:, j:j + 1],
                              active=active)
        assert torch.equal(vlogits[active, j], lj[active, 0]), j
    _assert_arena_equal(caches, seq)
    assert caches[0]["pos0"].length.tolist() == [8 + K + 1, 5 + K + 1, 7]


def _ref_prefill(setup, kv_bits):
    jm = setup["jm"]
    toks, lens = _prompts()
    rt = JRuntime(policy=setup["jsched"].policy_for(), mode="serve",
                  schedule=setup["jsched"], tier="8/8")
    logits, caches = jm.prefill(setup["jstore"], rt,
                                jm.init_cache(B, MAX_LEN, kv_bits=kv_bits),
                                tokens=jnp.asarray(toks),
                                seq_lengths=jnp.asarray(lens))
    return caches, jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)


def _assert_arena_close(jcaches, caches):
    """The whole arena against the reference's: lengths exact, K/V codes
    and scales within ATOL_KV."""
    jc = jcaches["pos0"]
    for i, layer in enumerate(caches):
        c = layer["pos0"]
        np.testing.assert_array_equal(np.asarray(jc.length[i]),
                                      c.length.numpy())
        for name in ("k", "v", "k_scale", "v_scale"):
            mine = getattr(c, name)
            if mine is None:
                continue
            ref = np.asarray(getattr(jc, name)[i]).astype(np.float32)
            np.testing.assert_allclose(ref, mine.float().numpy(), rtol=0,
                                       atol=ATOL_KV, err_msg=name)


def test_rejecting_round_arena(setup):
    """One greedy round with drafts rejected (int8 KV): the port's
    sequence — k draft steps at the draft layout, the length rollback,
    the verify window, the truncation — against sequential greedy decoding
    (below each length, bit for bit) and against the reference's own
    sequence run op by op (the whole arena; verify logits close)."""
    m, params = setup["m"], setup["stores"][False]
    rt_d, rt_v = (_port_runtime(setup, DRAFT_TIERS),
                  _port_runtime(setup, SLOT_TIERS))
    caches, tok0 = _port_prefill(setup, False, kv_bits=8)
    start = _clone(caches)
    spec = torch.tensor(SPEC_MASK)
    saved = slots_lib.pre_draft_state(caches, spec)
    tok, dtoks = tok0, []
    for _ in range(K):
        logits, _ = m.decode_step(params, rt_d, caches, tokens=tok[:, None])
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        dtoks.append(tok)
    slots_lib.merge_slots(caches, saved, spec)
    drafts = torch.stack(dtoks, dim=1)
    window = torch.cat([tok0[:, None], drafts], dim=1)
    vlogits, _ = m.verify_step(params, rt_v, caches, tokens=window,
                               active=spec)
    greedy = torch.argmax(vlogits, dim=-1).to(torch.int32)
    hit = (drafts == greedy[:, :K]).to(torch.int32)
    n_acc = torch.cumprod(hit, dim=1).sum(dim=1).to(torch.int32)
    assert (n_acc[spec] < K).any(), "no draft was rejected"
    e = torch.where(spec, n_acc + 1, torch.zeros_like(n_acc))
    slots_lib.truncate_kv_lengths(caches, K + 1 - e, spec)

    # Sequential greedy decoding from the prefilled arena: spec slots take
    # e steps at their own tier, the plain slot its k draft-phase steps.
    steps = torch.where(spec, e, torch.full_like(e, K))
    tok = tok0
    for j in range(K):
        logits, _ = m.decode_step(params, rt_v, start, tokens=tok[:, None],
                                  active=steps > j)
        tok = torch.where(steps > j, torch.argmax(
            logits[:, -1], dim=-1).to(torch.int32), tok)
    for c, s in zip(_arena(caches), _arena(start), strict=True):
        if c.ndim == 1:                                     # lengths
            assert torch.equal(c, s)
    for layer, layer_s in zip(caches, start):
        c, s = layer["pos0"], layer_s["pos0"]
        for b, n in enumerate(c.length.tolist()):
            for name in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(getattr(c, name)[b, :n],
                                   getattr(s, name)[b, :n]), (b, name)

    # The reference's sequence, op by op.
    jm, jstore = setup["jm"], setup["jstore"]
    jrt_d, jrt_v = (_ref_runtime(setup, DRAFT_TIERS),
                    _ref_runtime(setup, SLOT_TIERS))
    jspec_mask = jnp.asarray(SPEC_MASK)
    with jax.disable_jit():
        jcaches, jtok0 = _ref_prefill(setup, kv_bits=8)
        np.testing.assert_array_equal(np.asarray(jtok0), tok0.numpy())
        orig, jtok = jcaches, jtok0
        for _ in range(K):
            logits, jcaches = jm.decode_step(jstore, jrt_d, jcaches,
                                             tokens=jtok[:, None])
            jtok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        jcaches = jslots.merge_slots(jcaches, orig, jspec_mask)
        jlogits, jcaches = jm.verify_step(jstore, jrt_v, jcaches,
                                          tokens=jnp.asarray(window.numpy()),
                                          active=jspec_mask)
        jcaches = jslots.truncate_kv_lengths(
            jcaches, jnp.asarray((K + 1 - e).numpy()), jspec_mask)
    np.testing.assert_allclose(np.asarray(jlogits, np.float32),
                               vlogits.float().numpy(), rtol=0,
                               atol=ATOL_LOGITS)
    _assert_arena_close(jcaches, caches)


# ---------------------------------------------------------------- engine
def _engine(setup, backend="cuda", **kw):
    sched = uniform_schedule(TIERS, backend=backend)
    return ServeEngine(setup["m"], setup["params"],
                       Runtime(policy=sched.policy_for(), schedule=sched),
                       device="cpu", **{**ENGINE_KW, **kw})


def _with(specs, **fields):
    """Request specs with ``fields`` set on every uid % 3 != 2 (``spec``)
    or on all of them (``sampling``, a function of the uid)."""
    out = []
    for s in specs:
        s = dict(s)
        if "spec" in fields and s["uid"] % 3 != 2:
            s["spec"] = fields["spec"]
        if "sampling" in fields:
            s["sampling"] = fields["sampling"](s["uid"])
        out.append(s)
    return out


SAMPLING = lambda uid: [0.8, 40, uid]   # noqa: E731  (temperature, top_k, seed)


@pytest.fixture(scope="module")
def plain_streams(setup):
    return _engine(setup).run(to_requests(request_specs()))


@pytest.mark.parametrize("draft_tier,k", [("2/2", 1), ("2/2", 3),
                                          ("4/4", 1), ("4/4", 3)])
def test_greedy_speculative_equals_plain(setup, plain_streams, draft_tier, k):
    """Spec and plain slots mixed in every batch: the streams equal plain
    decoding's; no weight is prepared; events and stats hold."""
    eng = _engine(setup)
    calls = engine_mod.PREPARE_CALLS
    specs = _with(request_specs(), spec=[draft_tier, k])
    handles = [eng.submit(r) for r in to_requests(specs)]
    eng.drain()
    assert {h.uid: h.tokens for h in handles} == plain_streams
    assert engine_mod.PREPARE_CALLS == calls
    st = eng.stats
    assert st.spec_rounds > 0 and st.spec_verify_steps == st.spec_rounds
    assert st.spec_draft_steps == k * st.spec_rounds
    assert st.decode_slot_steps + st.decode_idle_slot_steps == \
        st.decode_steps * ENGINE_KW["max_batch"]
    assert 0 <= st.spec_accepted <= st.spec_drafted
    assert sum(st.tokens_by_tier.values()) == \
        sum(len(h.tokens) - 1 for h in handles)
    n_spec = 0
    for h in handles:
        spec_req = h.uid % 3 != 2
        assert [e.index for e in h.events] == list(range(len(h.tokens)))
        assert not h.events[0].speculative              # prefill's token
        assert all(not e.speculative for e in h.events) or spec_req
        assert not any(e.sampled for e in h.events)
        n_spec += sum(e.speculative for e in h.events)
    assert n_spec == st.spec_emitted


def _ssm_setup(arch):
    """A seeded reduced SSM / hybrid model, its superplane store and a
    tiered runtime (the port alone: the rollback is the port's own)."""
    m = LM(reduced_config(arch))
    sched = uniform_schedule(TIERS, backend="cuda")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = m.init(gen, device="cpu", prepare=lambda tree, prefix:
                    engine_mod.prepare_tree(tree, sched.prepare_policy(),
                                            prefix=prefix, superplane=True))
    return m, params, Runtime(policy=sched.policy_for(), schedule=sched)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mamba2-1.3b"])
def test_greedy_speculative_hybrid_arch(arch):
    """The verify window's rollback holds for SSM state (the twin of the
    reference's test of the same name): spec slots' SSM rows go back to
    their pre-draft copy, the verify replays from it and each slot keeps
    its last accepted step, while plain slots keep their draft-phase
    progress; greedy speculative streams equal plain ones, drafts both
    accepted (an 8/8 request drafting at its own tier) and rejected (4/4
    drafting at 2/2)."""
    m, params, rt = _ssm_setup(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=3 + 2 * i).astype(np.int32)
               for i in range(5)]

    def run(spec):
        eng = ServeEngine(m, params, rt, device="cpu", max_batch=3,
                          max_len=48, decode_chunk=2)
        out = eng.run([Request(
            uid=i, prompt=p, max_new_tokens=6 + i, tier=list(TIERS)[i % 3],
            spec=SpecConfig("8/8" if i % 3 == 0 else "2/2", 3)
            if spec and i % 3 != 2 else None)
            for i, p in enumerate(prompts)])
        return out, eng.stats

    plain, _ = run(False)
    spec, st = run(True)
    assert spec == plain
    assert st.spec_rounds > 0 and 0 < st.spec_accepted < st.spec_drafted


def test_verify_positions_hybrid_bit_equal_sequential_decode():
    """On the hybrid stack, every window position's logits equal the
    sequential decode step's, bit for bit, and the verify's stacked SSM
    states equal the states the decode steps leave; the arena's SSM rows
    are not written by the verify."""
    m, params, rt = _ssm_setup("jamba-1.5-large-398b")
    caches = m.init_cache(B, MAX_LEN, device="cpu")
    toks, lens = _prompts()
    m.prefill(params, rt.for_tier("8/8"), caches,
              tokens=torch.from_numpy(toks), seq_lengths=torch.from_numpy(lens))
    rt_v = rt.for_groups(*(lambda g, p: (g, torch.from_numpy(
        p.astype(np.int64))))(*_layout(SLOT_TIERS)))
    window = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, size=(B, K + 1)).astype(np.int32))
    active = torch.tensor(SPEC_MASK)
    seq = _clone(caches)
    before = _clone(caches)
    vlogits, verified = m.verify_step(params, rt_v, caches, tokens=window,
                                      active=active)
    for j in range(K + 1):
        lj, _ = m.decode_step(params, rt_v, seq, tokens=window[:, j:j + 1],
                              active=active)
        assert torch.equal(vlogits[active, j], lj[active, 0]), j
        for layer, vlayer in zip(seq, verified):
            for pos, c in layer.items():
                if not isinstance(c, KVCache):
                    for t, st in zip(c.tensors(), vlayer[pos].tensors()):
                        assert torch.equal(st[j], t), (j, pos)
    for layer, old in zip(caches, before):
        for pos, c in layer.items():
            if not isinstance(c, KVCache):
                for t, o in zip(c.tensors(), old[pos].tensors()):
                    assert torch.equal(t, o), pos


# Requests that fill a 32-position arena (prompt + budget == max_len), so
# a round's window runs past its end.
EDGE_KW = dict(max_batch=3, max_len=32)


def _edge_specs():
    rng = np.random.default_rng(5)
    return [{"uid": i, "prompt": rng.integers(0, 512, size=27).tolist(),
             "max_new": 5, "tier": t}
            for i, t in enumerate(("8/8", "4/4", "8/8"))]


@pytest.fixture(scope="module")
def reference_spec_runs(setup):
    """The reference engine's streams for greedy speculative requests
    mixed with plain ones, for sampled requests (spec and plain mixed),
    and for speculative and plain requests at the end of the arena."""
    specs = request_specs()
    runs = [_with(specs, spec=["2/2", 3]),
            _with(specs, spec=["2/2", 3], sampling=SAMPLING),
            {"engine": EDGE_KW, "requests": _edge_specs()},
            {"engine": EDGE_KW, "requests": [dict(s, spec=["2/2", 4])
                                             for s in _edge_specs()]}]
    streams, _ = reference_runs(ENGINE_KW, runs)
    return list(zip(runs, streams))


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
@pytest.mark.parametrize("run", [0, 1], ids=["greedy-spec", "sampled-spec"])
def test_streams_equal_reference_engine(setup, reference_spec_runs, backend,
                                        run):
    specs, ref = reference_spec_runs[run]
    eng = _engine(setup, backend)
    assert eng.run(to_requests(specs)) == ref
    assert eng.stats.spec_rounds > 0


def test_arena_end_equals_reference_engine(setup, reference_spec_runs):
    """A window that runs past max_len: the appends past the arena's end
    are dropped, yet the rollback rewinds the whole window, so the slot's
    length ends short and greedy speculative streams leave plain ones —
    in the reference as in the port (ROADMAP Queue 3).  The port follows
    the reference exactly, plain and speculative."""
    (plain, ref_plain), (spec, ref_spec) = reference_spec_runs[2:]
    assert ref_plain != ref_spec                # the reference's fault
    assert _engine(setup, **EDGE_KW).run(
        to_requests(plain["requests"])) == ref_plain
    assert _engine(setup, **EDGE_KW).run(
        to_requests(spec["requests"])) == ref_spec


def test_sampled_streams_independent_of_batch(setup):
    """Sampled streams depend on (seed, draw index) only: equal across
    max_batch, decode_chunk and backends; the events say ``sampled``."""
    specs = _with(request_specs(), sampling=SAMPLING)
    a = _engine(setup).run(to_requests(specs))
    eng = _engine(setup, "decomposed", max_batch=3, decode_chunk=5)
    handles = [eng.submit(r) for r in to_requests(specs)]
    eng.drain()
    assert {h.uid: h.tokens for h in handles} == a
    assert all(e.sampled for h in handles for e in h.events)
    greedy = _engine(setup).run(to_requests(request_specs()))
    assert a != greedy


def test_submit_errors(setup):
    eng = _engine(setup)
    prompt = np.ones((3,), np.int32)
    with pytest.raises(ValueError, match="unknown draft tier"):
        eng.submit(Request(uid=0, prompt=prompt, spec=SpecConfig("3/3")))
    with pytest.raises(ValueError, match="k must be >= 1"):
        eng.submit(Request(uid=1, prompt=prompt, spec=SpecConfig("2/2", 0)))
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        eng.submit(Request(uid=2, prompt=prompt,
                           sampling=SamplingParams(temperature=-1.0)))
    with pytest.raises(ValueError, match="top_k must be >= 0"):
        eng.submit(Request(uid=3, prompt=prompt,
                           sampling=SamplingParams(top_k=-2)))
    plain = ServeEngine(setup["m"], setup["params"],
                        Runtime(policy=uniform_policy(8, 8, backend="cuda")),
                        device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="needs an engine with a "
                       "PrecisionSchedule"):
        plain.submit(Request(uid=4, prompt=prompt, spec=SpecConfig("2/2")))
    # Sampling needs no schedule.
    plain.submit(Request(uid=5, prompt=prompt, max_new_tokens=3,
                         sampling=SamplingParams(0.5, 4, 1)))
    assert len(plain.drain()[5]) == 3


@pytest.mark.parametrize("argv,error", [
    (["--speculate"], "needs --tiers"),
    (["--tiers", "8/8", "2/2", "--speculate", "--spec-k", "0"],
     "--spec-k must be >= 1"),
    (["--tiers", "8/8", "2/2", "--speculate", "--draft-tier", "4/4"],
     "not one of the serving tiers"),
    (["--tiers", "8/8", "2/2", "--draft-tier", "2/2"], "needs --speculate"),
    (["--temperature", "-0.5"], "--temperature must be >= 0"),
    (["--top-k", "-1"], "--top-k must be >= 0")])
def test_serve_cli_errors(argv, error, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--reduced", "--device", "cpu"] + argv)
    assert error in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--tiers", "8/8", "4/4", "2/2", "--speculate", "--draft-tier", "2/2",
     "--spec-k", "4"],
    ["--tiers", "8/8", "2/2", "--speculate", "--temperature", "0.8",
     "--top-k", "40"],
    ["--w-bits", "4", "--temperature", "0.7"]])
def test_serve_cli_speculate_and_sample(argv, capsys):
    out = serve_cli.main(["--reduced", "--device", "cpu", "--max-new", "6",
                          "--max-len", "32", "--requests", "4"] + argv)
    assert sorted(out) == list(range(4))
    assert all(len(v) == 1 + (6 * (i % 4)) // 3 for i, v in out.items())
    printed = capsys.readouterr().out
    # The acceptance rate as serve_report's speculate section prints it
    # (the reference's report, its only spec line).
    rates = re.findall(r"^speculate: rounds=\d+ accepted=(\d+)/(\d+) "
                       r"\((\d+)%\)", printed, re.M)
    assert len(rates) == ("--speculate" in argv)
    for accepted, drafted, pct in rates:
        assert 0 < int(drafted) and 0 <= int(accepted) <= int(drafted)
        assert int(pct) == round(100 * int(accepted) / int(drafted))
    assert not re.search(r"^(stats|slo|spec) \{", printed, re.M)


def test_decomposed_spec_round_matches_cuda_backend(setup):
    """The plain backend and the kernel wrappers (their plain versions on
    the CPU) give the same speculative streams, greedy and sampled."""
    specs = _with(request_specs(), spec=["4/4", 2], sampling=SAMPLING)
    a = _engine(setup).run(to_requests(specs))
    b = _engine(setup, "decomposed").run(to_requests(specs))
    assert a == b
