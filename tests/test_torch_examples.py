"""The five example scripts of the port (``examples/*_torch.py``) held
against the reference scripts they twin, on the CPU.

The five reference scripts' ``main()`` run in ONE subprocess for the
module (started with the module's first test), under
``--xla_allow_excess_precision=false`` as ``_torch_reference`` runs the
reference engine; their standard output is captured.  Two of them print
less than the comparison needs, so the subprocess wraps what they call:
``long_context_ssm``'s ``jax.jit`` records the tokens fed to each decode
step, and ``precision_sweep``'s ``jax.jit`` (its train step),
``prepare_params`` and ``make_loss_fn`` record the last step's CE, the
trained params and each policy's CE at full precision.  ``train_qat``'s
launcher call records its argv.  Each twin's ``run`` takes the
reference's ``PRNGKey(0)`` weights, converted (``repro_torch.convert``).

Tolerances:

* quickstart: every line of sections 1-3 equal; section 4's plane counts
  equal and each mean relative error within ``QUICKSTART_ATOL`` (one unit
  of the printed fourth decimal: the mean is an f32 sum in another order).
* serve_quantized: the prepared-weight count, every streamed token, every
  stream and the decode stats equal.
* long_context_ssm: the state bytes equal, and the 256 x 2 greedy tokens
  equal.
* precision_sweep: on the reference's trained weights, each policy's CE
  within ``SWEEP_EVAL_RTOL`` of the reference's (f32 sums in another
  order); the twin's own 60-step run from the converted initialisation,
  whose bf16 QAT steps part from the reference's jitted ones
  (``test_torch_train`` bounds 4 steps), within ``SWEEP_TRAIN_RTOL`` for
  the trained CE and each policy's (measured 0.82 % at most, w2a8).
* train_qat: argv equal to the reference's plus ``--device cpu``; the
  logged losses (steps 1, 10, ..., 60) within ``TRAIN_QAT_RTOL`` (the same
  parting; measured 1.4 % at most, step 40; step 1, before any update,
  3e-4 apart: the jitted forward's).
"""
import ast
import json
import os
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_reference import ROOT, reference_weights
from repro.data import pipeline as jdata
from repro_torch.configs import reduced_config
from repro_torch.convert import convert_params
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import tree_map

sys.path.insert(0, str(ROOT / "examples"))
import long_context_ssm_torch as long_context_ssm  # noqa: E402
import precision_sweep_torch as precision_sweep  # noqa: E402
import quickstart_torch as quickstart  # noqa: E402
import serve_quantized_torch as serve_quantized  # noqa: E402
import train_qat_torch as train_qat  # noqa: E402

TWINS = {"quickstart": quickstart, "serve_quantized": serve_quantized,
         "long_context_ssm": long_context_ssm,
         "precision_sweep": precision_sweep, "train_qat": train_qat}
QUICKSTART_ATOL = 1e-4
SWEEP_EVAL_RTOL = 1e-5
SWEEP_TRAIN_RTOL = 0.02
TRAIN_QAT_RTOL = 0.03

REFERENCE = r"""
import contextlib, io, json, pathlib, pickle, sys
root, out = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
sys.path.insert(0, str(root / "examples"))
import jax, numpy as np
import long_context_ssm, precision_sweep, quickstart, serve_quantized
import train_qat


class Jax:
    # A module's ``jax`` whose jit records each call through ``record``.
    def __init__(self, record):
        self.record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        f = jax.jit(fn)

        def call(*args):
            res = f(*args)
            self.record(args, res)
            return res
        return call


rec = {"fed": [], "train_ce": None, "sweep_ce": [], "train_argv": None}
long_context_ssm.jax = Jax(
    lambda args, res: rec["fed"].append(np.asarray(args[2])[:, 0].tolist()))
precision_sweep.jax = Jax(
    lambda args, res: rec.update(train_ce=float(res[1]["ce"])))
prepare = precision_sweep.prepare_params


def prepare_params(params, pol, model):
    if not (out / "sweep_params.pkl").exists():
        with open(out / "sweep_params.pkl", "wb") as fh:
            pickle.dump(jax.tree.map(np.asarray, params), fh)
    return prepare(params, pol, model)


precision_sweep.prepare_params = prepare_params
make_loss = precision_sweep.make_loss_fn


def make_loss_fn(model, rt):
    fn = make_loss(model, rt)

    def loss(p, b):
        res = fn(p, b)
        rec["sweep_ce"].append(float(res[0]))
        return res
    return loss


precision_sweep.make_loss_fn = make_loss_fn
launch = train_qat.train_driver.main


def train_main(argv):
    rec["train_argv"] = list(argv)
    return launch(argv)


train_qat.train_driver.main = train_main
stdout = {}
for name, mod in (("quickstart", quickstart),
                  ("serve_quantized", serve_quantized),
                  ("long_context_ssm", long_context_ssm),
                  ("precision_sweep", precision_sweep),
                  ("train_qat", train_qat)):
    sys.argv = [name + ".py"] + (["--ckpt-dir", str(out / "ckpt")]
                                 if name == "train_qat" else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    stdout[name] = buf.getvalue()
print(json.dumps({"stdout": stdout, **rec}))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def reference(tmp_path_factory):
    """Starts the reference scripts' subprocess with the module's first
    test; calling the fixture's value waits for it and returns (its JSON
    record, its output directory)."""
    out = tmp_path_factory.mktemp("reference_examples")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ROOT), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def result():
        if "rec" not in box:
            stdout, stderr = proc.communicate(timeout=900)
            assert proc.returncode == 0, stderr[-4000:]
            box["rec"] = json.loads(stdout.strip().splitlines()[-1])
        return box["rec"], out
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def qwen_weights():
    return reference_weights("qwen3-8b")[3]


@pytest.fixture
def qwen(qwen_weights):
    """The reduced qwen3-8b's PRNGKey(0) weights, converted (a fresh copy
    for each test)."""
    return tree_map(torch.clone, qwen_weights)


def _lines(text: str):
    return "\n".join(text).splitlines() if isinstance(text, list) \
        else text.splitlines()


# ------------------------------------------------------------- quickstart
QS_ROW = re.compile(r"^  w(\d)a8: (\d) (?:MXU pass\(es\)|plane\(s\) in one "
                    r"GEMM), mean rel err ([0-9.]+)$")


def test_quickstart_matches_reference(reference):
    rec, _ = reference()
    want = _lines(rec["stdout"]["quickstart"])
    got = _lines(quickstart.run("cpu")["lines"])
    assert len(got) == len(want)
    head = want.index("== 4. TPU plane-decomposed matmul, quality per "
                      "precision ==")
    assert got[:head] == want[:head]
    assert got[head].startswith("== 4. Plane-decomposed matmul")
    for g, w in zip(got[head + 1:], want[head + 1:]):
        mg, mw = QS_ROW.match(g), QS_ROW.match(w)
        assert mg and mw, (g, w)
        assert mg.group(1, 2) == mw.group(1, 2)
        assert abs(float(mg.group(3)) - float(mw.group(3))) <= \
            QUICKSTART_ATOL, (g, w)


def test_quickstart_accumulators_exact():
    """Section 4's int32 accumulators are the exact integer products of the
    8-bit codes and the recomposed planes, and the kernel wrappers' plain
    path (backend ``cuda`` on CPU tensors) gives the same bits."""
    from repro_torch.core import decompose
    from repro_torch.core.policy import LayerPrecision
    from repro_torch.kernels import ops
    plain = quickstart.run("cpu")
    wrapped = quickstart.run("cpu", backend="cuda")
    rng = np.random.default_rng(0)
    rng.integers(-16, 16, size=(4,))
    rng.integers(-8, 8, size=(2, 16)), rng.integers(-16, 16, size=(16, 3))
    rng.integers(-2, 2, size=(4, 64)), rng.integers(-2, 2, size=(64, 64))
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32))
    wf = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    x_q, _ = ops.quantize_activations(x, 8, plain=True)
    for bits in quickstart.WIDTHS:
        qw = ops.prepare_weight(wf, LayerPrecision(bits, 8))
        w_int = decompose.recompose_weights(qw.planes, bits).numpy()
        want = x_q.numpy().astype(np.int64) @ w_int
        np.testing.assert_array_equal(plain["acc"][bits].numpy(), want)
        assert torch.equal(wrapped["acc"][bits], plain["acc"][bits])
        assert torch.equal(wrapped["y"][bits], plain["y"][bits])


# -------------------------------------------------------- serve_quantized
def test_serve_quantized_matches_reference(reference, qwen):
    rec, _ = reference()
    want = _lines(rec["stdout"]["serve_quantized"])
    res = serve_quantized.run(params=qwen, device="cpu")
    got = _lines(res["lines"])
    assert len(got) == len(want)
    # The prepared-weight count, the streamed tokens and every stream.
    same = [i for i, w in enumerate(want)
            if not w.startswith(("served ", "decode: "))]
    assert [got[i] for i in same] == [want[i] for i in same]
    served = re.compile(r"^served (\d+) requests / (\d+) tokens")
    decode = re.compile(r"^decode: (\d+) (?:jitted )?steps in (\d+) chunk "
                        r"dispatches, (\d+) active slot-steps$")
    for pat in (served, decode):
        g = [pat.match(x) for x in got if pat.match(x)]
        w = [pat.match(x) for x in want if pat.match(x)]
        assert len(g) == len(w) == 1
        assert g[0].groups() == w[0].groups()
    assert res["quantized"] == 8


def test_quantized_paths_are_the_references(qwen):
    """``ServeEngine.quantized_paths``: the reference's key paths of the
    prepared weights (the stacked layout's), for a fixed-width store."""
    from repro.core.policy import uniform_policy as juniform_policy
    from repro.serve.engine import prepare_params as jprepare
    from repro_torch.core.policy import uniform_policy
    from repro_torch.serve.engine import prepare_params, quantized_paths
    jm, jp, _, _ = reference_weights("qwen3-8b")
    _, want = jprepare(jp, juniform_policy(4, 8, backend="decomposed"), jm)
    prepared, _ = prepare_params(qwen, uniform_policy(4, 8, "decomposed"),
                                 None)
    assert quantized_paths(prepared) == sorted(want)


# ------------------------------------------------------- long_context_ssm
def test_long_context_ssm_matches_reference(reference):
    rec, _ = reference()
    want = _lines(rec["stdout"]["long_context_ssm"])
    _, _, _, params = reference_weights("mamba2-1.3b")
    res = long_context_ssm.run(params=params, device="cpu")
    got = _lines(res["lines"])
    assert got[0] == want[0]             # the state bytes
    assert got[2] == want[2]
    # The reference's first call is its warm-up (zeros, as the first step).
    fed = np.asarray(rec["fed"][1:])
    assert fed.shape == (long_context_ssm.STEPS, long_context_ssm.BATCH)
    np.testing.assert_array_equal(res["tokens"].numpy(), fed)


# -------------------------------------------------------- precision_sweep
ROW = re.compile(r"^(.{18}) +([0-9.]+) +([0-9.]+) +([0-9.]+)%$")


def _table(lines):
    return {m.group(1).strip(): m.groups()[1:] for m in map(ROW.match, lines)
            if m}


def test_precision_sweep_evaluation_matches_reference(reference):
    """The six policies' CE on the reference's own trained weights."""
    rec, out = reference()
    with open(out / "sweep_params.pkl", "rb") as fh:
        trained = convert_params(pickle.load(fh), device="cpu")
    model = LM(reduced_config("qwen3-8b"))
    data = precision_sweep.data_for(model.cfg.vocab_size)
    held = precision_sweep.batch_on(data, precision_sweep.HELD_OUT_STEP,
                                    torch.device("cpu"))
    lines = []
    sweep = precision_sweep.evaluate(model, trained, held, "decomposed",
                                     lines.append)
    assert list(sweep) == list(precision_sweep.policies("decomposed"))
    np.testing.assert_allclose([v["ce"] for v in sweep.values()],
                               rec["sweep_ce"], rtol=SWEEP_EVAL_RTOL)
    want = _table(_lines(rec["stdout"]["precision_sweep"]))
    got = _table(lines)
    assert {k: v[1:] for k, v in got.items()} == \
        {k: v[1:] for k, v in want.items()}     # pJ/MAC and rel energy


def test_precision_sweep_run_matches_reference(reference, qwen):
    rec, _ = reference()
    res = precision_sweep.run(params=qwen, device="cpu")
    np.testing.assert_allclose(res["train_ce"], rec["train_ce"],
                               rtol=SWEEP_TRAIN_RTOL)
    got = [v["ce"] for v in res["sweep"].values()]
    np.testing.assert_allclose(got, rec["sweep_ce"], rtol=SWEEP_TRAIN_RTOL)
    want = _lines(rec["stdout"]["precision_sweep"])
    assert len(_lines(res["lines"])) == len(want)
    assert _lines(res["lines"])[1] == want[1]     # the table's header


def test_precision_sweep_data_matches_reference():
    jd = jdata.SyntheticLM(jdata.DataConfig(vocab_size=512, seq_len=32,
                                            global_batch=16))
    td = precision_sweep.data_for(512)
    for step in (0, 59, precision_sweep.HELD_OUT_STEP):
        for k, v in jd.batch(step).items():
            np.testing.assert_array_equal(td.batch(step)[k], v)


# ------------------------------------------------------------- train_qat
LOSS = re.compile(r"^step +(\d+) loss=([0-9.]+) ")


def test_train_qat_matches_reference(reference, qwen, tmp_path, capsys):
    rec, out = reference()
    capsys.readouterr()
    res = train_qat.run("ci", str(tmp_path / "ckpt"), "cpu", params=qwen)
    printed = capsys.readouterr().out
    ref_argv = list(rec["train_argv"])
    ref_argv[ref_argv.index("--ckpt-dir") + 1] = str(tmp_path / "ckpt")
    assert res["argv"] == ref_argv + ["--device", "cpu"]
    got = {int(m.group(1)): float(m.group(2))
           for m in map(LOSS.match, printed.splitlines()) if m}
    want = {int(m.group(1)): float(m.group(2))
            for m in map(LOSS.match, _lines(rec["stdout"]["train_qat"]))
            if m}
    assert sorted(got) == sorted(want) == [1, 10, 20, 30, 40, 50, 60]
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)],
                               rtol=TRAIN_QAT_RTOL)
    # The run checkpointed as the reference's does, and resumes.
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.name.startswith("step_")) == \
        ["step_00000030", "step_00000060"]
    train_qat.run("ci", str(tmp_path / "ckpt"), "cpu")
    assert "auto-resumed from step 60" in capsys.readouterr().out


def test_full_preset_is_the_references():
    """The full preset's flags, read from the reference script's source
    (its ``argv`` list under ``if args.preset == "full"``)."""
    tree = ast.parse((ROOT / "examples" / "train_qat.py").read_text())
    branch = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                  and "full" in ast.unparse(n.test))
    flags = [e.value if isinstance(e, ast.Constant) else "D"
             for e in branch.body[0].value.elts]
    assert train_qat.preset_argv("full", "D") == flags


# ------------------------------------------------------------ every twin
@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_refuses_to_run_without_a_card(name):
    """The default device is cuda: with no card the twin raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        TWINS[name].main([])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_imports_torch_numpy_and_the_port_only(name):
    tree = ast.parse(pathlib.Path(TWINS[name].__file__).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert mods and all(m.split(".")[0] in (
        "argparse", "os", "tempfile", "time", "typing", "numpy", "torch",
        "repro_torch") for m in mods), mods
