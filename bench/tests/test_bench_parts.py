"""A configuration is built, weighed, checked and counted from its file
alone (``benchlib/parts.py``): a key the harness would not pass on, or a
pattern other than the program's, is refused by name; an MoE file builds
an MoE engine; a model module under ``bench/models/`` supplies the parts
it defines to the build, the check and the readers; the counts follow the
pattern."""
import textwrap
import types

import pytest
import torch

import bench_tiny as T
from benchlib import cell, counts, parts, serve

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cfg,key", [
    (dict(T.QWEN, num_expert=4), "num_expert"),
    (dict(T.HYBRID, attn_period=4), "attn_period"),
    (dict(T.MAMBA, ssm_groups=1), "ssm_groups")],
    ids=["qwen3", "hybrid", "mamba2"])
def test_a_key_the_harness_does_not_pass_on_is_refused(cfg, key):
    with pytest.raises(ValueError, match=repr(key)):
        serve.build_engine(cfg, T.CLOSED, 2**31 + 1, CPU)


@pytest.mark.parametrize("cfg", [
    dict(T.HYBRID, pattern=[["attn", "moe"], ["mamba", "mlp"],
                            ["mamba", "moe"], ["mamba", "mlp"]]),
    dict(T.MOE, pattern=[["attn", "mlp"]]),
    dict(T.QWEN, pattern=[["attn", "moe"]])],
    ids=["hybrid-attn-first", "moe-as-dense", "dense-as-moe"])
def test_a_pattern_other_than_the_programs_is_refused(cfg):
    with pytest.raises(ValueError, match="'pattern'"):
        serve.build_engine(cfg, T.CLOSED, 2**31 + 1, CPU)


def test_moe_and_hybrid_files_state_their_pattern():
    for cfg in (T.MOE, T.HYBRID):
        bare = {k: v for k, v in cfg.items() if k != "pattern"}
        with pytest.raises(ValueError, match="must state its 'pattern'"):
            parts.pattern(bare)
    assert parts.pattern(T.QWEN) == (("attn", "mlp"),)
    assert parts.pattern(T.MAMBA) == (("mamba", None),)


@pytest.mark.parametrize("cfg", [T.MOE, T.HYBRID], ids=["moe", "hybrid"])
def test_the_moe_engine_holds_moe_blocks(cfg):
    """Every position the file's pattern gives an MoE holds the router and
    the experts, quantized per expert, in the engine that is served."""
    from repro_torch.kernels.ops import QuantizedWeight
    eng = serve.build_engine(cfg, T.CLOSED, 2**31 + 3, CPU)
    assert eng.rt.moe_dropless
    pat = parts.pattern(cfg)
    assert tuple(eng.model.pattern) == pat
    assert len(eng.params["layers"]) == cfg["num_layers"] // len(pat)
    for period in eng.params["layers"]:
        for j, (mixer, ff) in enumerate(pat):
            blk = period[f"pos{j}"]
            assert mixer in blk and ("mlp" in blk) == (ff == "mlp")
            assert ("moe" in blk) == (ff == "moe")
            if ff == "moe":
                moe = blk["moe"]
                assert moe["router"]["w"].shape == (cfg["d_model"],
                                                    cfg["num_experts"])
                assert moe["router"]["w"].dtype == torch.float32
                w = moe["gate_proj"]["w"]
                assert isinstance(w, QuantizedWeight)
                assert w.scale.shape[0] == cfg["num_experts"]
                assert "shared" in moe


OWN = '''
from benchlib import reference, weights

CALLS = []


def make_params(cfg, seed, device):
    CALLS.append("make_params")
    return weights.make_params(cfg, seed, device)


class Reference(reference.Reference):
    def logits(self, *args, **kwargs):
        CALLS.append("Reference.logits")
        return super().logits(*args, **kwargs)


def token_ops(cfg, context):
    CALLS.append("token_ops")
    return 1.0e9
'''


def test_a_model_module_supplies_its_parts(monkeypatch, tmp_path):
    """``"model": "<stem>"`` imports ``bench/models/<stem>.py``: the build
    takes its ``make_params``, the check its ``Reference``, ``decode_mfu``
    its ``token_ops``; the parts it leaves out are the harness's."""
    (tmp_path / "tiny-own.py").write_text(textwrap.dedent(OWN))
    monkeypatch.setattr(parts, "MODELS", tmp_path)
    cfg = dict(T.QWEN, model="tiny-own")
    own = parts.module("tiny-own")
    got = parts.of(cfg)
    assert got.projections is counts.projections
    assert got.token_ops is own.token_ops
    res = T.run(cfg, T.CLOSED, "qwen3-8b.reason-decode", seconds=0.5)
    assert res["correct"], res["checks"]
    assert own.CALLS.count("make_params") == 1
    assert "Reference.logits" in own.CALLS
    ctx = types.SimpleNamespace(cfg=cfg, delta=lambda key: 2.0,
                                decode_contexts=lambda: [5, 6, 7])
    from benchlib import peaks
    assert cell.load_reader("decode_mfu")(ctx) == pytest.approx(
        100.0 * 3.0e9 / 2.0 / peaks.PEAK_OPS_INT8)
    assert own.CALLS.count("token_ops") == 3
    with pytest.raises(ValueError, match="'model'"):
        parts.of(dict(T.QWEN, model="no-such-model"))


def test_counts_follow_the_pattern():
    """The hybrid's counts by hand: its four layers' projections, its two
    MoE layers' routers, routed experts (2 of 4) and shared experts, its
    three Mamba2 layers' recurrence and conv, its attention layer."""
    cfg = T.HYBRID
    d, f, e, k = 64, 64, 4, 2
    di, ns, p, h = 128, 16, 16, 8
    mamba = d * (2 * di + 2 * ns + h) + di * d
    attn = d * 64 + 2 * d * 32 + 64 * d
    mlp = 3 * d * f
    head = d * 60160
    per_token = 2.0 * (3 * mamba + attn + 2 * mlp + 2 * mlp + head) \
        + 2 * (2.0 * d * e + k * 2.0 * mlp)
    core = 3 * (4.0 * h * ns * p + 2.0 * 4 * (di + 2 * ns))
    assert counts.token_ops(cfg, 10) == per_token + core + 4.0 * 64 * 10
    assert counts.prompt_ops(cfg, 6) == (per_token - 2.0 * head + core) * 6 \
        + 2.0 * head + 2.0 * 64 * 6 * 7
    # Kernel 3 at 32 rows: each held expert's planes read once, the routed
    # rows' operations (32 x 2) at each expert projection.
    one = counts.plane_launch(64, d, f, 4, False)
    ops, nbytes = counts.all_experts(cfg, one, 4 * d * f)
    assert ops == 2.0 * 64 * d * f
    assert nbytes == one[1] + 3 * 4 * d * f
    assert counts.plane_gemms(cfg, 32, 4, False, 0) > \
        counts.plane_gemms(dict(cfg, num_experts=1, experts_per_token=1),
                           32, 4, False, 0)
