"""repro_torch's hardware-aware precision search held against the JAX
package's, on the reduced granite-3-8b with the reference's weights
converted (``_torch_reference.reference_weights``).

* ``quant_layer_macs`` names exactly the projections ``prepare_params``
  quantizes (granite, mamba2, llama4 reduced), with the reference's MACs.
* Sensitivity: the port's ``profile_sensitivity`` against the reference's
  run op by op (``jax.disable_jit``), calibration 1 x 2 x 8, widths 2 and
  4 over all 8 layers.  The port's logits equal the reference's op by op
  (``test_torch_model.py``), so what differs is the f32 ``log_softmax``
  and the mean's summation order: ``mse`` agrees to ``RTOL_MSE`` (measured
  5.7e-7 relative) and ``kl``, a sum of tiny differences of two
  log-probabilities, to ``RTOL_KL`` + ``ATOL_KL`` (measured 6e-8
  absolute at the smallest value, 3.9e-5).  Within the port the batched
  one-pass profiler equals the sequential one EXACTLY, and the 8-bit probe
  is exactly 0.0.
* Search on one table (the reference's profile, and the reference tests'
  toy table): ``greedy_search``, ``relaxed_search`` (the port's on the
  CPU), ``search`` and ``pareto_front`` give the reference's assignments,
  cycles, energies and predicted divergences.
* Schedule files written by either package load in the other (the port's
  ``cuda`` is the file's ``pallas``).
* The CLI end to end (the reference test's sizes): its schedule file
  loads, prices below uniform-8 within the divergence bound, and serves
  token-identically to the in-memory schedule with no re-preparation;
  ``launch.serve --schedule-file`` refuses conflicting flags with the
  reference's messages.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from _torch_reference import reference_weights
from repro import autoprec as jap
from repro.configs import reduced_config as jreduced
from repro.core import policy as jpol
from repro_torch import autoprec as tap
from repro_torch.configs import reduced_config
from repro_torch.core import policy as tpol
from repro_torch.core.decompose import RUNTIME_W_BITS
from repro_torch.core.policy import PrecisionSchedule
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request

ARCH = "granite-3-8b"
CHOICES = (2, 4)
RTOL_MSE = 1e-5
RTOL_KL, ATOL_KL = 1e-4, 1e-6


@functools.lru_cache(maxsize=None)
def _calib():
    return tap.random_calibration(reduced_config(ARCH), batches=1, batch=2,
                                  seq=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These CPU ops are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(reference model, reference params, port model, converted params)."""
    jm, jp, _, tp = reference_weights(ARCH)
    return jm, jp, LM(reduced_config(ARCH)), tp


@pytest.fixture(scope="module")
def ref_profile(weights):
    """The reference's profile, op by op (its jit becomes eager)."""
    jm, jp, _, _ = weights
    with jax.disable_jit():
        return jap.profile_sensitivity(jm, jp, calib=_calib(),
                                       choices=CHOICES)


# ----------------------------------------------------------- layer workload
def _port_layer_name(path: str) -> str:
    return engine_mod._layer_name(tuple(int(p) if p.isdigit() else p
                                        for p in path.split(".")))


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b",
                                  "llama4-scout-17b-a16e"])
def test_quant_layer_macs_names_match_prepared_weights(arch):
    cfg = reduced_config(arch)
    model = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    _, paths = engine_mod.prepare_params(
        params, tpol.uniform_policy(8, 8, backend="decomposed"), model)
    prepared = sorted({_port_layer_name(p) for p in paths})
    macs = cfg.quant_layer_macs()
    assert sorted(macs) == prepared
    assert macs == jreduced(arch).quant_layer_macs()
    assert all(isinstance(m, int) and m > 0 for m in macs.values())


# ------------------------------------------------------------- sensitivity
@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_profile_close_to_reference(weights, ref_profile, backend):
    _, _, model, tp = weights
    prof = tap.profile_sensitivity(model, tp, calib=_calib(),
                                   choices=CHOICES, backend=backend)
    assert prof.layers == ref_profile.layers
    assert prof.choices == ref_profile.choices
    for n in prof.layers:
        for b in CHOICES:
            assert prof.mse[n][b] == pytest.approx(ref_profile.mse[n][b],
                                                   rel=RTOL_MSE), (n, b)
            assert prof.kl[n][b] == pytest.approx(
                ref_profile.kl[n][b], rel=RTOL_KL, abs=ATOL_KL), (n, b)


@pytest.mark.parametrize("backend", ["cuda", "decomposed"])
def test_batched_one_pass_profiler_matches_sequential(weights, backend):
    """Bit-identical, and the 8-bit probe is exactly 0 (the twin of the
    reference's test of the same name)."""
    _, _, model, tp = weights
    layers = ["layers.pos0.attn.q_proj", "layers.pos0.mlp.down_proj",
              "lm_head"]
    kw = dict(calib=_calib(), choices=(2, 4, 8), layers=layers,
              backend=backend)
    prof_b = tap.profile_sensitivity(model, tp, batched=True, block=4, **kw)
    prof_s = tap.profile_sensitivity(model, tp, batched=False, **kw)
    for n in layers:
        for b in (2, 4, 8):
            assert prof_b.kl[n][b] == prof_s.kl[n][b], (n, b)
            assert prof_b.mse[n][b] == prof_s.mse[n][b], (n, b)
        assert prof_b.kl[n][8] == 0.0 and prof_b.mse[n][8] == 0.0
        assert prof_b.kl[n][2] > 0.0
        assert all(v >= 0.0 for v in prof_b.kl[n].values())
    assert prof_b.table is prof_b.kl


def test_measure_divergence_joint_and_moe_falls_back(weights):
    """Joint assignments: all-8 is exactly 0, lowering layers moves it;
    the batched and sequential shapes agree exactly.  A MoE config
    profiles sequentially by default, as the reference's does."""
    _, _, model, tp = weights
    names = list(model.cfg.quant_layer_macs())
    points = {"all8": {n: 8 for n in names}, "all2": {n: 2 for n in names},
              "mlp4": {n: 4 if ".mlp." in n else 8 for n in names}}
    kw = dict(calib=_calib(), backend="cuda")
    got = tap.measure_divergence(model, tp, points, **kw)
    seq = tap.measure_divergence(model, tp, points, batched=False, **kw)
    assert got == seq
    assert got["all8"] == 0.0 and got["all2"] > got["mlp4"] > 0.0
    moe_cfg = reduced_config("llama4-scout-17b-a16e")
    moe = LM(moe_cfg)
    mp = moe.init(torch.Generator().manual_seed(0), device="cpu")
    calib = tap.random_calibration(moe_cfg, batches=1, batch=2, seq=4)
    layer = next(iter(moe_cfg.quant_layer_macs()))
    auto = tap.profile_sensitivity(moe, mp, calib=calib, choices=(2,),
                                   layers=[layer])
    seq = tap.profile_sensitivity(moe, mp, calib=calib, choices=(2,),
                                  layers=[layer], batched=False)
    assert auto.kl == seq.kl and auto.mse == seq.mse


# ------------------------------------------------------------------ search
def _tables(ref_profile, which):
    """(sens table, reference cost model, port cost model)."""
    jcost = jap.CostModel.for_config(jreduced(ARCH))
    tcost = tap.CostModel.for_config(reduced_config(ARCH))
    if which == "profile":
        return ref_profile.table, jcost, tcost
    sens = {n: {2: 1.0 / (i + 1), 4: 0.25 / (i + 1), 6: 0.05 / (i + 1)}
            for i, n in enumerate(tcost.layers)}
    return sens, jcost, tcost


def _fields(results):
    return [dataclasses.asdict(r) for r in results]


@pytest.mark.parametrize("which", ["profile", "toy"])
@pytest.mark.parametrize("strategy", ["greedy", "relaxed", "both"])
def test_search_equals_reference(ref_profile, which, strategy):
    sens, jcost, tcost = _tables(ref_profile, which)
    assert (tcost.macs, tcost.a_bits) == (jcost.macs, jcost.a_bits)
    choices = CHOICES + (8,) if which == "profile" else (2, 4, 6, 8)
    if strategy == "greedy":
        want = jap.greedy_search(sens, jcost, choices=choices)
        got = tap.greedy_search(sens, tcost, choices=choices)
    elif strategy == "relaxed":
        lams = jap.default_lambdas(sens, jcost, choices=choices)
        assert tap.default_lambdas(sens, tcost, choices=choices) == lams
        want = jap.relaxed_search(sens, jcost, choices=choices)
        got = tap.relaxed_search(sens, tcost, choices=choices, device="cpu")
    else:
        want = jap.search(sens, jcost, choices=choices)
        got = tap.search(sens, tcost, choices=choices, device="cpu")
    assert _fields(got) == _fields(want)
    assert _fields(tap.pareto_front(got)) == _fields(jap.pareto_front(want))


@pytest.mark.parametrize("lam", [1e-4, 1e-2])
def test_relaxed_search_anneals_to_separable_optimum(ref_profile, lam):
    sens, _, cost = _tables(ref_profile, "toy")
    (res,) = tap.relaxed_search(sens, cost, choices=(2, 4, 6, 8),
                                lambdas=[lam], device="cpu")
    for layer in cost.layers:
        want = min((2, 4, 6, 8), key=lambda b: (
            (sens[layer].get(b, 0.0) if b < 8 else 0.0)
            + lam * cost.layer_cycles(layer, b)))
        assert res.assignment[layer] == want, (layer, lam)
    with pytest.raises(ValueError):
        tap.search(sens, cost, strategy="bogus", device="cpu")


# ------------------------------------------------------------- persistence
def _searched(pol, backend):
    base = pol.LayerPrecision(w_bits=8, a_bits=8, backend=backend)
    return pol.PrecisionSchedule(
        tiers={"auto": base, "base": base},
        rules={"auto": {
            "layers.pos0.attn.q_proj": dataclasses.replace(base, w_bits=4),
            "layers.pos0.mlp.*": dataclasses.replace(base, w_bits=2)}},
        default_tier="auto", kv_tiers={"auto": 8, "base": None})


@pytest.mark.parametrize("backends", [("decomposed", "decomposed"),
                                      ("cuda", "pallas")])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_schedule_files_load_in_both_packages(tmp_path, writer, backends):
    tb, jb = backends
    tsched, jsched = _searched(tpol, tb), _searched(jpol, jb)
    path = str(tmp_path / "sched.json")
    if writer == "port":
        tap.save_schedule(path, tsched, meta={"note": "port"})
    else:
        jap.save_schedule(path, jsched, meta={"note": "reference"})
    loaded, meta = tap.load_schedule_with_meta(path)
    assert loaded == tsched and meta == {"note": writer}
    assert jap.load_schedule(path) == jsched
    # The dict forms are the same JSON.
    assert json.dumps(tap.schedule_to_dict(tsched), sort_keys=True) \
        == json.dumps(jap.schedule_to_dict(jsched), sort_keys=True)
    assert PrecisionSchedule.from_json_dict(tsched.to_json_dict()) == tsched


def test_schedule_file_validation_rejects_bad_contents(tmp_path):
    d = tap.schedule_to_dict(_searched(tpol, "cuda"))
    d["rules"]["auto"]["layers.pos0.attn.q_proj"]["w_bits"] = 5
    with pytest.raises(ValueError):          # odd width: not truncatable
        tap.schedule_from_dict(d)
    d2 = tap.schedule_to_dict(_searched(tpol, "cuda"))
    del d2["tiers"]["auto"]["a_signed"]
    with pytest.raises(ValueError):
        tap.schedule_from_dict(d2)
    with pytest.raises(ValueError):
        tap.schedule_from_dict({"rules": {}})
    path = str(tmp_path / "bogus.json")
    with open(path, "w") as f:
        f.write('{"format": "something.else", "schedule": {}}')
    with pytest.raises(ValueError):
        tap.load_schedule(path)
    res = tap.SearchResult(assignment={"lm_head": 4}, a_bits=8, avg_bits=4.0,
                           cycles_per_token=1.0, energy_per_token_j=1.0,
                           pred_divergence=0.0, strategy="greedy")
    sched = tap.schedule_from_results([res], tier_names=["auto"],
                                      backend="cuda")
    assert sched.lookup("lm_head", "auto").w_bits == 4
    assert sched.lookup("lm_head", "base").w_bits == 8
    assert tap.result_to_meta(res) == jap.result_to_meta(
        jap.SearchResult(**dataclasses.asdict(res)))
    for bad in (dict(results=[dataclasses.replace(
            res, assignment={"lm_head": 3})]),
            dict(results=[res], tier_names=["base"]), dict(results=[])):
        with pytest.raises(ValueError):
            tap.schedule_from_results(**bad)


# ------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from repro_torch.launch.autoprec import main as autoprec_main
    path = str(tmp_path_factory.mktemp("autoprec") / "auto_sched.json")
    out = autoprec_main([
        "--arch", ARCH, "--reduced", "--choices", "2", "4",
        "--calib-batches", "1", "--calib-batch", "2", "--calib-len", "8",
        "--eval-top", "3", "--max-divergence", "0.05", "--out", path,
        "--device", "cpu"])
    return out, path


def test_autoprec_cli_end_to_end_and_serving(weights, cli_run):
    _, _, model, tp = weights
    out, path = cli_run
    loaded, meta = tap.load_schedule_with_meta(path)
    assert loaded == out["schedule"]
    assert {p.backend for p in loaded._all_precisions()} == {"cuda"}
    assert all(p.w_bits in RUNTIME_W_BITS for p in loaded._all_precisions())
    assert jap.load_schedule(path).tier_names == loaded.tier_names
    cost = tap.CostModel.for_config(reduced_config(ARCH))
    selected = out["selected"]
    assignment = {n: int(b)
                  for n, b in meta["selected"]["assignment"].items()}
    assert cost.cycles_per_token(assignment) \
        == pytest.approx(selected.cycles_per_token)
    assert selected.cycles_per_token < cost.uniform_cycles(8)
    assert selected.measured_divergence <= 0.05
    assert meta["pareto_front"], "front must be persisted"

    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, size=3 + i % 3),
                    max_new_tokens=2 + i % 2,
                    tier=("auto", "base")[i % 2]) for i in range(4)]
    kw = dict(max_batch=2, max_len=32, decode_chunk=2, device="cpu")
    eng_mem = ServeEngine(model, tp, Runtime(
        policy=out["schedule"].policy_for(), moe_dropless=True,
        schedule=out["schedule"]), **kw)
    eng_load = ServeEngine(model, eng_mem.params, Runtime(
        policy=loaded.policy_for(), moe_dropless=True, schedule=loaded),
        **kw)
    preps = engine_mod.PREPARE_CALLS
    got_mem = eng_mem.run(reqs)
    got_load = eng_load.run([dataclasses.replace(r) for r in reqs])
    assert engine_mod.PREPARE_CALLS == preps, "re-prepared after construction"
    assert got_mem == got_load
    assert all(len(v) == r.max_new_tokens
               for r, v in zip(reqs, got_mem.values()))


SERVE = ["--reduced", "--arch", ARCH, "--device", "cpu"]


@pytest.mark.parametrize("extra,message", [
    (["--tiers", "8/8"], "--schedule-file carries its own tiers; drop "
     "--tiers"),
    (["--kv-tiers", "8"], "--schedule-file carries its own kv_tiers; drop "
     "--kv-tiers"),
    (["--backend", "dense"], "--schedule-file needs an integer backend"),
    (["--baseline"], "--baseline has no per-request tier switching; drop "
     "--schedule-file"),
    (["--backend", "decomposed"], "--backend decomposed does not match the "
     "schedule file's backend(s) ['cuda']"),
])
def test_schedule_file_flag_errors(cli_run, capsys, extra, message):
    _, path = cli_run
    with pytest.raises(SystemExit):
        serve_cli.main(SERVE + ["--schedule-file", path] + extra)
    assert message in capsys.readouterr().err


def test_schedule_file_kv_bits_conflict_and_serve(tmp_path, capsys):
    path = str(tmp_path / "kv.json")
    tap.save_schedule(path, _searched(tpol, "cuda"))
    with pytest.raises(SystemExit):
        serve_cli.main(SERVE + ["--schedule-file", path, "--kv-bits", "8"])
    assert "--kv-bits conflicts with the schedule file's kv_tiers" \
        in capsys.readouterr().err
    res = serve_cli.main(SERVE + ["--schedule-file", path, "--requests", "3",
                                  "--max-new", "3", "--max-len", "32"])
    assert sorted(res) == [0, 1, 2]
    assert all(len(v) >= 1 for v in res.values())
