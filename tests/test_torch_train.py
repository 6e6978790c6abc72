"""repro_torch's QAT training held against the JAX package on the CPU:
the synthetic data, ``fake_quant``'s gradient, AdamW, the loss and its
gradients, accumulation, checkpoints and the ``launch.train`` command
line, plus the supervisor.

* Data: batches EXACT (both tasks, shards, the embed stub, over steps);
  the reference's six checks of ``tests/test_data.py`` on the port.
* ``fake_quant`` gradients against ``jax.grad`` of the reference's: an
  amax tie, values exactly at ``qmin``/``qmax``, exact zeros under
  unsigned quantization (a clip bound passes half the gradient, as
  ``jnp.clip`` does) and a given scale's own gradient; within
  ``ATOL_FQ`` (the amax element's gradient is a float-noise difference
  of two terms, measured 2.4e-6).
* AdamW: ``lr_at`` and ``1 - b**t`` within ``ULPS`` f32 ulps of the
  jitted reference's over 300 steps (``lr_at`` multiplies by the f32
  reciprocals XLA puts for its two divisions by constants; ``cos``
  differs by up to 3 ulps, measured);
  given the reference's ``lr``, bias corrections and grad norm, one
  update EXACT with f32 and with bf16 moments, against the reference's
  update run op by op (under ``jit`` XLA fuses the moment updates, which
  then differ from op by op in the last bit of some elements).
* Loss and gradients against ``jax.value_and_grad`` of the reference's
  loss, jitted, at ``dtype_str="float32"`` on converted weights, fake_quant
  w4a8: dense qwen3-8b, MoE llama4-scout (aux > 0), pixtral-12b
  (``embeds=``).  Loss within ``RTOL_LOSS``, each gradient leaf within
  ``RTOL_GRAD`` of its largest entry (measured 1.2e-5 at most; f32 sums
  in another order).  At bf16 the forward's logits EXACT against the
  reference run op by op.
* Accumulation == full batch (the reference's own test and tolerance);
  resume and the command line's auto-resume EXACT; train states saved by
  either package restore EXACT in the other and continue; 4 bf16 QAT
  steps of both packages from one initialisation part no further than
  ``RTOL_UPDATE`` (see the test).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import reduced_config as jreduced
from repro.core import quant as jquant
from repro.core.policy import uniform_policy as juniform_policy
from repro.data import pipeline as jdata
from repro.models.layers import Runtime as JRuntime
from repro.models.transformer import LM as JLM
from repro.train import optimizer as joptim
from repro.train.step import make_loss_fn as jmake_loss_fn
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs import reduced_config
from repro_torch.convert import convert_params, stack_layers, to_torch
from repro_torch.core import quant
from repro_torch.core.policy import uniform_policy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.supervisor import Supervisor, SupervisorConfig
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as optim
from repro_torch.train.step import (cross_entropy, make_loss_fn,
                                    make_train_step, value_and_grad)

ATOL_FQ = 1e-5
ULPS = 4
RTOL_LOSS = 1e-5
RTOL_GRAD = 1e-4
ATOL_JIT_LOSS = 2e-2
RTOL_UPDATE = 0.36
GRAD_ARCHS = ("qwen3-8b", "llama4-scout-17b-a16e", "pixtral-12b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree) -> dict:
    """keystr path -> f32 numpy, for a reference tree or a port tree (the
    port's layers stacked into the reference's periods)."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {p: t.detach().to(torch.float32).numpy()
                for p, t in _flatten(stack_layers(tree))}
    return {jax.tree_util.keystr(kp): np.asarray(a, np.float32)
            for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want) -> None:
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -------------------------------------------------------------------- data
def _data_tokens_deterministic(cls):
    a = cls(DataConfig(vocab_size=100, seq_len=8, global_batch=4))
    b = cls(DataConfig(vocab_size=100, seq_len=8, global_batch=4))
    for step in (0, 1, 17):
        np.testing.assert_array_equal(a.batch(step)["tokens"],
                                      b.batch(step)["tokens"])


def _data_steps_differ(cls):
    d = cls(DataConfig(vocab_size=100, seq_len=8, global_batch=4))
    assert not np.array_equal(d.batch(0)["tokens"], d.batch(1)["tokens"])


def _data_shards_differ(cls):
    d = cls(DataConfig(vocab_size=1000, seq_len=8, global_batch=8))
    s0 = d.batch(0, shard=0, num_shards=2)
    s1 = d.batch(0, shard=1, num_shards=2)
    assert s0["tokens"].shape == (4, 8)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def _data_labels_next(cls):
    d = cls(DataConfig(vocab_size=50, seq_len=8, global_batch=2,
                       task="uniform"))
    b = d.batch(0)
    assert b["tokens"].shape == b["labels"].shape


def _data_arith_learnable(cls):
    d = cls(DataConfig(vocab_size=97, seq_len=64, global_batch=8))
    b = d.batch(0)
    hits = total = 0
    for r in range(b["tokens"].shape[0]):
        deltas = (b["labels"][r] - b["tokens"][r]) % 97
        hits += (deltas == np.bincount(deltas).argmax()).sum()
        total += len(deltas)
    assert hits / total > 0.75


def _data_embed_stub(cls):
    d = cls(DataConfig(vocab_size=100, seq_len=8, global_batch=2,
                       embed_dim=16))
    b = d.batch(0)
    assert b["embeds"].shape == (2, 8, 16)
    assert b["embeds"].dtype == np.float32


@pytest.mark.parametrize("check", [
    _data_tokens_deterministic, _data_steps_differ, _data_shards_differ,
    _data_labels_next, _data_arith_learnable, _data_embed_stub],
    ids=lambda f: f.__name__[6:])
def test_data_checks_of_the_reference(check):
    check(SyntheticLM)


@pytest.mark.parametrize("task,shards,embed", [
    ("arith", 1, 0), ("uniform", 1, 0), ("arith", 2, 0), ("uniform", 4, 0),
    ("arith", 1, 24)])
def test_batches_equal_the_reference(task, shards, embed):
    kw = dict(vocab_size=151936, seq_len=33, global_batch=8, seed=5,
              task=task, embed_dim=embed)
    got, want = SyntheticLM(DataConfig(**kw)), jdata.SyntheticLM(
        jdata.DataConfig(**kw))
    for step in (0, 1, 17, 2**32 + 3):
        for shard in range(shards):
            g = got.batch(step, shard=shard, num_shards=shards)
            w = want.batch(step, shard=shard, num_shards=shards)
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


# -------------------------------------------------------------- fake_quant
def _fq_case(name):
    """(x, QuantConfig kwargs, scale or None, cotangent) of one case."""
    rng = np.random.default_rng(11)
    if name == "amax_tie":
        x = rng.normal(size=(16, 8)).astype(np.float32)
        x[3, 2] = x[9, 2] = 4.0           # two equal maxima in channel 2
        x[5, 6], x[7, 6] = 3.0, -3.0      # +amax and -amax in channel 6
        return x, dict(bits=4), None, rng.normal(size=x.shape)
    if name == "clip_edges":               # x / scale exactly qmin, qmax
        x = np.array([[1.75, -2.0, 0.5, 2.5], [-2.5, 1.75, -2.0, 0.0]],
                     np.float32)
        return (x, dict(bits=4, per_channel=False), np.float32(0.25),
                rng.normal(size=x.shape))
    if name == "unsigned_zeros":           # post-relu6: qmin == 0 ties
        x = np.maximum(rng.normal(size=(6, 32)), 0).astype(np.float32)
        return (x, dict(bits=8, signed=False, per_channel=False), None,
                rng.normal(size=x.shape))
    x = rng.normal(size=(8, 16)).astype(np.float32) * 2    # given scale
    scale = np.abs(rng.normal(size=(1, 16))).astype(np.float32) * 0.3 + 0.05
    return x, dict(bits=4), scale, rng.normal(size=x.shape)


@pytest.mark.parametrize("name", ["amax_tie", "clip_edges",
                                  "unsigned_zeros", "given_scale"])
def test_fake_quant_gradient_equals_jax_grad(name):
    x, kw, scale, ct = _fq_case(name)
    ct = ct.astype(np.float32)
    jcfg, tcfg = jquant.QuantConfig(**kw), quant.QuantConfig(**kw)
    if scale is None:
        want = [jax.grad(lambda a: jnp.sum(jquant.fake_quant(a, jcfg) * ct))(
            jnp.asarray(x))]
        xt = torch.from_numpy(x).requires_grad_(True)
        got = torch.autograd.grad(
            torch.sum(quant.fake_quant(xt, tcfg) * torch.from_numpy(ct)), xt)
    else:
        want = jax.grad(lambda a, s: jnp.sum(
            jquant.fake_quant(a, jcfg, s) * ct), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(scale))
        xt = torch.from_numpy(x).requires_grad_(True)
        st = torch.tensor(scale).requires_grad_(True)
        got = torch.autograd.grad(
            torch.sum(quant.fake_quant(xt, tcfg, st) * torch.from_numpy(ct)),
            (xt, st))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_FQ)
    if name in ("clip_edges", "unsigned_zeros"):
        # The half gradient at a bound is the reference's rule.
        edge = (x == 0) if name == "unsigned_zeros" else \
            (np.abs(x / scale) == np.array([7.0, 8.0])[(x < 0) * 1])
        assert edge.any()
        np.testing.assert_allclose(got[0].numpy()[edge], 0.5 * ct[edge],
                                   rtol=1e-6)


# --------------------------------------------------------------- optimizer
def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.float32(a), np.float32(b)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_schedule_scalars_within_ulps_of_the_reference():
    kw = dict(lr=3e-3, warmup_steps=15, total_steps=300)
    jcfg, tcfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)

    @jax.jit
    def ref(step):
        t = (step + 1).astype(jnp.float32)
        return (joptim.lr_at(jcfg, step), 1 - jcfg.b1 ** t,
                1 - jcfg.b2 ** t)
    worst = 0.0
    for step in range(300):
        want = ref(jnp.asarray(step, jnp.int32))
        s = torch.tensor(step, dtype=torch.int32)
        got = (optim.lr_at(tcfg, s), *optim.bias_corrections(tcfg, s))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == ()
            worst = max(worst, float(_ulps(g.item(), np.asarray(w))))
    assert worst <= ULPS, worst


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(moments, monkeypatch):
    """Given the reference's scalars, one step from a nonzero state (bf16
    matrices, an f32 vector) is bit-equal: params, both moments, step."""
    rng = np.random.default_rng(3)
    cfg_kw = dict(lr=1e-2, warmup_steps=3, total_steps=20,
                  moment_dtype=moments, grad_clip=0.5)
    jcfg, tcfg = joptim.OptConfig(**cfg_kw), optim.OptConfig(**cfg_kw)
    shapes = {"a": (16, 8), "b": (8,), "c": (4, 3, 5)}
    dt = {"a": jnp.bfloat16, "b": jnp.float32, "c": jnp.bfloat16}
    params = {k: jnp.asarray(rng.normal(size=s), dt[k])
              for k, s in shapes.items()}
    grads = {k: jnp.asarray(rng.normal(size=s), dt[k])
             for k, s in shapes.items()}
    mdt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    state = {"m": {k: jnp.asarray(rng.normal(size=s) * 0.1, mdt)
                   for k, s in shapes.items()},
             "v": {k: jnp.asarray(rng.random(size=s) * 0.1, mdt)
                   for k, s in shapes.items()},
             "step": jnp.asarray(4, jnp.int32)}
    want_p, want_s, want_m = joptim.apply_updates(params, grads, state, jcfg)
    t = (state["step"] + 1).astype(jnp.float32)
    scalars = {"lr": joptim.lr_at(jcfg, state["step"]),
               "bc": (1 - jcfg.b1 ** t, 1 - jcfg.b2 ** t),
               "gnorm": joptim.global_norm(grads)}

    def tt(a):
        return to_torch(np.asarray(a), "cpu")
    monkeypatch.setattr(optim, "lr_at", lambda c, s: tt(scalars["lr"]))
    monkeypatch.setattr(optim, "bias_corrections",
                        lambda c, s: tuple(map(tt, scalars["bc"])))
    monkeypatch.setattr(optim, "global_norm", lambda g: tt(scalars["gnorm"]))
    tp, tg = jax.tree.map(tt, params), jax.tree.map(tt, grads)
    ts = jax.tree.map(tt, state)
    got_p, got_s, got_m = optim.apply_updates(tp, tg, ts, tcfg)
    assert float(scalars["gnorm"]) > 0.5          # the clip is active
    for k in shapes:
        assert got_p[k].dtype == tp[k].dtype
        assert got_s["m"][k].dtype == ts["m"][k].dtype
        for got, want in ((got_p[k], want_p[k]), (got_s["m"][k],
                                                  want_s["m"][k]),
                          (got_s["v"][k], want_s["v"][k])):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    assert int(got_s["step"]) == int(want_s["step"]) == 5


def _opt_lr_schedule():
    cfg = optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)

    def lr(s):
        return float(optim.lr_at(cfg, torch.tensor(s)))
    assert lr(0) < 0.2
    assert lr(10) == pytest.approx(1.0, abs=0.05)
    assert lr(100) == pytest.approx(0.1, abs=0.01)


def _opt_moment_dtype_bf16():
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    st = optim.init_state(params, optim.OptConfig(moment_dtype="bfloat16"))
    assert st["m"]["w"].dtype == torch.bfloat16


def _opt_grad_clip_bounds_update():
    p = {"w": torch.ones((2, 2))}
    g = {"w": torch.full((2, 2), 1e6)}
    cfg = optim.OptConfig(lr=1e-2, grad_clip=1.0, warmup_steps=0,
                          total_steps=10, weight_decay=0.0)
    newp, _, metrics = optim.apply_updates(p, g, optim.init_state(p, cfg),
                                           cfg)
    assert float(metrics["grad_norm"]) > 1e5
    assert (newp["w"] - 1.0).abs().max() < 0.1


def _opt_cross_entropy_masking():
    logits = torch.zeros((1, 4, 8))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    assert float(cross_entropy(logits, labels)) == pytest.approx(
        float(cross_entropy(logits, labels, mask)))


@pytest.mark.parametrize("check", [
    _opt_lr_schedule, _opt_moment_dtype_bf16, _opt_grad_clip_bounds_update,
    _opt_cross_entropy_masking], ids=lambda f: f.__name__[5:])
def test_optimizer_checks_of_the_reference(check):
    check()


# ------------------------------------------------------- loss and gradients
@functools.lru_cache(maxsize=None)
def _model(arch: str, dtype_str: str):
    """(reference LM, its params, port LM, converted params)."""
    jm = JLM(dataclasses.replace(jreduced(arch), dtype_str=dtype_str))
    jp = jm.init(jax.random.PRNGKey(0))
    m = LM(dataclasses.replace(reduced_config(arch), dtype_str=dtype_str))
    return jm, jp, m, convert_params(jax.tree.map(np.asarray, jp), "cpu")


def _lm_batch(cfg, step: int = 0, batch: int = 4, seq: int = 16) -> dict:
    emb = cfg.d_model if cfg.frontend != "none" else 0
    b = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        embed_dim=emb)).batch(step)
    if emb:
        b.pop("tokens")
    return b


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_close_to_the_jitted_reference(arch):
    jm, jp, m, tp = _model(arch, "float32")
    b = _lm_batch(jm.cfg)
    jrt = JRuntime(policy=juniform_policy(4, 8, backend="fake_quant"))
    rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant"))
    (_, want_m), want_g = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jm, jrt), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got_m, got_g = value_and_grad(make_loss_fn(m, rt), tp, _torch_batch(b))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=RTOL_LOSS, atol=1e-7, err_msg=k)
    if arch.startswith("llama4"):
        assert float(got_m["aux"]) > 0
    got, want = _leaves(got_g), _leaves(want_g)
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=0,
                                   atol=RTOL_GRAD * np.abs(w).max(),
                                   err_msg=p)


def test_qat_logits_equal_the_reference_op_by_op():
    """bf16, fake_quant w4a8: the forward's logits EXACT against the
    reference run op by op (its aux is 0 on a dense model)."""
    jm, jp, m, tp = _model("qwen3-8b", "bfloat16")
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 8)).astype(
        np.int32)
    with jax.disable_jit():
        want, _ = jm.forward(jp, JRuntime(policy=juniform_policy(
            4, 8, backend="fake_quant")), tokens=jnp.asarray(toks))
    got, aux = m.forward(tp, Runtime(policy=uniform_policy(
        4, 8, backend="fake_quant")), tokens=torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.asarray(want).view(np.uint16))


# ------------------------------------------------------ train step, resume
def test_grad_accumulation_matches_full_batch():
    """The reference's test of the same name, on the port (its
    tolerances: ce rel 1e-3, params atol 4e-3)."""
    cfg = reduced_config("granite-3-8b")
    model = LM(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, device="cpu")
    rt = Runtime(policy=uniform_policy(8, 8, backend="dense"))
    batch = _torch_batch(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)).batch(0))
    ocfg = optim.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    out1, m1 = make_train_step(model, rt, ocfg, accum_steps=1)(state, batch)
    out4, m4 = make_train_step(model, rt, ocfg, accum_steps=4)(state, batch)
    assert float(m1["ce"]) == pytest.approx(float(m4["ce"]), rel=1e-3)
    for a, b in zip(optim.tree_leaves(out1["params"]),
                    optim.tree_leaves(out4["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=4e-3)


def test_resume_equals_uninterrupted(tmp_path):
    """4 steps straight against 2 + checkpoint + restore + 2: bit-equal."""
    _, _, m, tp = _model("qwen3-8b", "bfloat16")
    ocfg = optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    step = make_train_step(m, Runtime(policy=uniform_policy(
        4, 8, backend="fake_quant")), ocfg)
    data = SyntheticLM(DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16,
                                  global_batch=4))

    def run(state, steps):
        for i in steps:
            state, _ = step(state, _torch_batch(data.batch(i)))
        return state
    start = {"params": tp, "opt": optim.init_state(tp, ocfg)}
    straight = run(start, range(4))
    half = run(start, range(2))
    ckpt.save(str(tmp_path), 2, train_cli.checkpoint_tree(half),
              extra={"data_step": 2})
    restored, extra = train_cli.restore_state(str(tmp_path), 2, start, "cpu")
    assert extra == {"data_step": 2}
    _assert_trees_equal(restored, half)
    _assert_trees_equal(run(restored, range(2, 4)), straight)


@functools.lru_cache(maxsize=None)
def _qat_pair():
    """The reduced qwen3-8b (bf16) in both packages on one initialisation,
    with their train steps at phase 4g (c)'s flags: w4a8 fake_quant, lr
    3e-3 with 5 warmup steps, seq 64, batch 8 (the reference's jitted)."""
    jm, jp, m, tp = _model("qwen3-8b", "bfloat16")
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=4)
    jcfg, ocfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)
    jstep = jax.jit(jmake_train_step(
        jm, JRuntime(policy=juniform_policy(4, 8, backend="fake_quant")),
        jcfg))
    step = make_train_step(m, Runtime(policy=uniform_policy(
        4, 8, backend="fake_quant")), ocfg)
    data = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=jm.cfg.vocab_size, seq_len=64, global_batch=8))
    return (jp, {"params": jp, "opt": joptim.init_state(jp, jcfg)}, jstep,
            tp, {"params": tp, "opt": optim.init_state(tp, ocfg)}, step,
            data)


def _jbatch(data, i: int) -> dict:
    return {k: jnp.asarray(v) for k, v in data.batch(i).items()}


def test_four_steps_track_the_jitted_reference():
    """4 QAT steps of both packages from one initialisation: losses within
    ATOL_JIT_LOSS, and the port's update (final - initial weights) within
    RTOL_UPDATE of the reference's in relative L2.  AdamW's first step
    moves each weight by +-lr whatever its gradient's size (a near-zero
    gradient that rounds to the other sign moves it the other way) and
    8-bit activation codes flip on .5 boundaries with the summation order,
    so runs that agree op by op to a few ulps part this far (measured
    0.18, the jitted reference skipping bf16 roundings).  Phase 4g (c)
    holds the card against the CPU to twice that."""
    jp, jstate, jstep, tp, state, step, data = _qat_pair()
    for i in range(4):
        jstate, jmetrics = jstep(jstate, _jbatch(data, i))
        state, metrics = step(state, _torch_batch(data.batch(i)))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
            < ATOL_JIT_LOSS
    got, want, init = (_leaves(state["params"]), _leaves(jstate["params"]),
                       _leaves(jp))
    num = sum(float(((got[p] - want[p]) ** 2).sum()) for p in want)
    den = sum(float(((want[p] - init[p]) ** 2).sum()) for p in want)
    assert (num / den) ** 0.5 <= RTOL_UPDATE, (num / den) ** 0.5


def test_train_states_restore_across_packages(tmp_path):
    """A reference train state (after one jitted step) restores EXACT in
    the port, which continues; the port's state restores EXACT in the
    reference, which continues.  The continuing steps' losses agree within
    ATOL_JIT_LOSS (the jitted reference skips bf16 roundings)."""
    _, jstate, jstep, _, template, step, data = _qat_pair()
    jstate, _ = jstep(jstate, _jbatch(data, 0))
    jckpt.save(str(tmp_path / "ref"), 1, jstate, extra={"data_step": 1})
    state, extra = train_cli.restore_state(str(tmp_path / "ref"), 1,
                                           template, "cpu")
    assert extra == {"data_step": 1} and int(state["opt"]["step"]) == 1
    _assert_trees_equal(state, jstate)
    state, metrics = step(state, _torch_batch(data.batch(1)))
    jnext, jmetrics = jstep(jstate, _jbatch(data, 1))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
        < ATOL_JIT_LOSS

    ckpt.save(str(tmp_path / "port"), 2, train_cli.checkpoint_tree(state),
              extra={"data_step": 2})
    back, jextra = jckpt.restore(str(tmp_path / "port"), 2, jnext)
    assert jextra == {"data_step": 2} and int(back["opt"]["step"]) == 2
    _assert_trees_equal(state, back)
    _, jmetrics = jstep(back, _jbatch(data, 2))
    _, metrics = step(state, _torch_batch(data.batch(2)))
    assert np.isfinite(float(jmetrics["loss"]))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
        < ATOL_JIT_LOSS


def test_cli_auto_resume_equals_the_first_run(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path)]
    first = train_cli.main(argv)
    assert ckpt.list_steps(str(tmp_path)) == [2, 4]
    ckpt.remove(str(tmp_path), 4)
    capsys.readouterr()
    again = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "auto-resumed from step 2" in out and "step     3 " in out
    _assert_trees_equal(again, first)


# -------------------------------------------------------------- supervisor
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(n=4, timeout=10.0, patience=2):
    clock = FakeClock()
    sup = Supervisor(SupervisorConfig(heartbeat_timeout_s=timeout,
                                      straggler_factor=2.0,
                                      straggler_patience=patience,
                                      min_workers=1), clock=clock)
    for i in range(n):
        sup.register(i)
    return sup, clock


def test_dead_node_evicted_on_timeout():
    sup, clock = _fleet()
    for step in range(3):
        clock.t += 1.0
        for uid in (0, 1, 2):            # worker 3 goes silent
            sup.heartbeat(uid, step, 1.0)
        assert sup.check() == [] or clock.t <= 10.0
    clock.t += 11.0
    for uid in (0, 1, 2):
        sup.heartbeat(uid, 3, 1.0)
    assert sup.check() == [3]
    assert sup.alive_workers() == [0, 1, 2]
    assert sup.generation == 1


def test_straggler_evicted_after_patience():
    sup, clock = _fleet(patience=2)
    evictions = []
    for step in range(4):
        clock.t += 1.0
        for uid in range(4):
            sup.heartbeat(uid, step, 5.0 if uid == 2 else 1.0)
        evictions += sup.check()
    assert evictions == [2]
    assert 2 not in sup.alive_workers()


def test_fast_fleet_not_evicted():
    sup, clock = _fleet()
    for step in range(5):
        clock.t += 1.0
        for uid in range(4):
            sup.heartbeat(uid, step, 1.0 + 0.1 * uid)   # mild skew only
        assert sup.check() == []
    assert sup.alive_workers() == [0, 1, 2, 3]


def test_remesh_plan_after_eviction():
    sup, clock = _fleet()
    for step in range(3):
        clock.t += 1.0
        for uid in (0, 1, 2):
            sup.heartbeat(uid, step, 1.0)
    clock.t += 20.0
    for uid in (0, 1, 2):
        sup.heartbeat(uid, 3, 1.0)
    sup.check()
    plan = sup.remesh_plan(chips_per_worker=4)
    assert plan == {"generation": 1, "workers": [0, 1, 2], "n_chips": 12,
                    "resume_step": 3}


def test_min_workers_floor():
    sup, clock = _fleet(n=2)
    sup.cfg = SupervisorConfig(heartbeat_timeout_s=1.0, min_workers=2)
    clock.t += 100.0                    # everyone times out...
    assert sup.check() == []            # ...but the floor holds the fleet
    assert len(sup.alive_workers()) == 2
