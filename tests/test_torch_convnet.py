"""repro_torch's MobileNetV2-style ConvNet held against the JAX package's
on the CPU, on the reference's weights converted.

* Forward and gradients against ``jax.value_and_grad`` of the reference's
  loss (jitted), default config, f32, on 4 images.  Dense backend: logits
  within ``ATOL_LOGITS``, each gradient leaf within ``RTOL_GRAD`` of its
  largest entry (measured 7.9e-7; the convs sum in another order).
  fake_quant w4a8 with unsigned activations (``a_signed=False``, after
  relu6): logits within ``ATOL_LOGITS`` (measured 1.3e-5), each gradient
  leaf within ``RTOL_L2_QAT`` in relative L2 norm and all leaves together
  within ``RTOL_L2_QAT_ALL`` (measured 7.7e-3).  QAT gradients are that sensitive: an 8-bit
  activation code on a .5 boundary flips with the f32 summation order,
  and the straight-through scale term carries the flip to every input of
  that quantizer.  The reference's own jitted and op-by-op runs differ by
  up to 9.4e-2 per leaf on this input; the port's run differs from the
  jitted one by up to 1.1e-1 (measured).
* The reference's own tests on the port: shapes and finite logits, and
  QAT learning its synthetic image classes (signSGD, 40 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import uniform_policy as juniform_policy
from repro.models.convnet import ConvNet as JConvNet
from repro.models.convnet import ConvNetConfig as JConvNetConfig
from repro.models.layers import Runtime as JRuntime
from repro_torch.convert import to_torch
from repro_torch.core.policy import uniform_policy
from repro_torch.models.convnet import ConvNet, ConvNetConfig
from repro_torch.models.layers import Runtime
from repro_torch.train import optimizer as optim
from repro_torch.train.step import value_and_grad

ATOL_LOGITS = 1e-4
RTOL_GRAD = 1e-4
RTOL_L2_QAT = 0.2
RTOL_L2_QAT_ALL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _convert(tree):
    """A reference ConvNet params tree (dicts and the blocks list)."""
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v) for v in tree]
    return to_torch(np.asarray(tree), "cpu")


def _ce(logits, ys):
    lse = torch.logsumexp(logits, -1)
    return torch.mean(lse - logits.gather(1, ys[:, None])[:, 0])


def _jce(logits, ys):
    lse = jax.nn.logsumexp(logits, -1)
    return jnp.mean(lse - jnp.take_along_axis(logits, ys[:, None], 1)[:, 0])


@pytest.mark.parametrize("backend", ["fake_quant", "dense"])
def test_forward_and_grads_close_to_the_reference(backend):
    jnet, net = JConvNet(JConvNetConfig()), ConvNet(ConvNetConfig())
    jp = jnet.init(jax.random.PRNGKey(0))
    tp = _convert(jp)
    jrt = JRuntime(policy=juniform_policy(4, 8, backend=backend,
                                          a_signed=False))
    rt = Runtime(policy=uniform_policy(4, 8, backend=backend,
                                       a_signed=False))
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=4)

    def jloss(p):
        logits = jnet.apply(p, jnp.asarray(xs), jrt)
        return _jce(logits, jnp.asarray(ys)), logits
    (want_l, want_logits), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)

    def loss(p, batch):
        logits = net.apply(p, batch["x"], rt)
        ce = _ce(logits, batch["y"])
        return ce, {"loss": ce, "logits": logits}
    got, got_g = value_and_grad(loss, tp, {"x": torch.from_numpy(xs),
                                           "y": torch.from_numpy(ys)})
    assert got["logits"].shape == (4, 10)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want_logits), rtol=0,
                               atol=ATOL_LOGITS)
    assert float(got["loss"]) == pytest.approx(float(want_l), rel=1e-5)
    flat_w = [np.asarray(w) for w in jax.tree.leaves(want_g)]
    flat_g = [g.numpy() for g in optim.tree_leaves(got_g)]
    assert [g.shape for g in flat_g] == [w.shape for w in flat_w]
    if backend == "dense":
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=RTOL_GRAD * np.abs(w).max())
        return
    rel = [np.linalg.norm(g - w) / np.linalg.norm(w)
           for g, w in zip(flat_g, flat_w)]
    assert max(rel) <= RTOL_L2_QAT, rel
    cat = [np.concatenate([a.ravel() for a in t]) for t in (flat_g, flat_w)]
    total = np.linalg.norm(cat[0] - cat[1]) / np.linalg.norm(cat[1])
    assert total <= RTOL_L2_QAT_ALL, total


def test_forward_shapes_and_finite():
    net = ConvNet(ConvNetConfig())
    gen = torch.Generator()
    gen.manual_seed(0)
    params = net.init(gen, device="cpu")
    rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant",
                                       a_signed=False))
    logits = net.apply(params, torch.randn((2, 32, 32, 3), generator=gen),
                       rt)
    assert logits.shape == (2, 10)
    assert torch.isfinite(logits).all()


def test_learns_synthetic_classes():
    """Mixed-precision QAT learns a linearly separable image task (the
    reference's test of the same name, its data and signSGD step)."""
    cfg = ConvNetConfig(num_classes=4, blocks=((1, 16, 1), (4, 24, 2)))
    net = ConvNet(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = net.init(gen, device="cpu")
    rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant",
                                       a_signed=False))
    rng = np.random.default_rng(0)
    patterns = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                         [0.6, 0.6, 0.6]], np.float32)

    def loss(p, batch):
        ce = _ce(net.apply(p, batch["x"], rt), batch["y"])
        return ce, {"loss": ce}
    losses = []
    for _ in range(40):
        ys = rng.integers(0, 4, size=16)
        xs = rng.normal(size=(16, 32, 32, 3)).astype(np.float32) * 0.1
        xs += patterns[ys][:, None, None, :]
        metrics, grads = value_and_grad(loss, params, {
            "x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
        params = optim.tree_map(lambda a, b: a - 0.01 * torch.sign(b),
                                params, grads)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::6]
