"""The check that decides ``correct``, at tiny sizes on the CPU: the port
served through the benchmark's loop agrees with the plain reference; the
control (the reference one precision step lower in the program's place)
and the timed path broken underneath each come out not correct."""
import pytest
import torch

import bench_tiny as T
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine

CELLS = [(T.QWEN, T.CLOSED, "qwen3-8b.reason-decode"),
         (T.QWEN, T.OPEN, "qwen3-8b.rag-prefill"),
         (T.MAMBA, T.CLOSED, "mamba2-1.3b.long-decode")]
IDS = ["qwen3-closed", "qwen3-open", "mamba2-closed"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cfg,mix,name", CELLS, ids=IDS)
def test_port_agrees_with_reference_and_control_does_not(cfg, mix, name):
    res = T.run(cfg, mix, name, control=True)
    r = res["readings"]
    assert res["correct"], res["checks"]
    assert r["checked_tokens"] >= 20
    lim = T.limits(name)["gap"]
    assert r["gap"] < lim / 10
    # The control, judged by the same limits, is not correct, and every
    # tier's control (2/2 too) reads wider than the program's widest gap.
    assert res["control_correct"] is False, res["control_checks"]
    assert res["control_checks"]["gap"]["value"] > lim
    for tier in cfg["tiers"]:
        assert r[f"control_gap_{tier}"] > r["gap"], (tier, r)


def _state_unchanged(monkeypatch, cfg):
    """A decode step that leaves the cache as it found it."""
    if cfg["family"] == "ssm":
        inner = ssm._decode_core

        def frozen(params, cfg_, conv, state, *a, **k):
            y, _, _ = inner(params, cfg_, conv, state, *a, **k)
            return y, conv, state
        monkeypatch.setattr(ssm, "_decode_core", frozen)
    else:
        monkeypatch.setattr(layers.KVCache, "append",
                            lambda self, k, v, active=None: self)


def _half_batch(monkeypatch, cfg):
    """A decode step that computes half of the batch and hands its rows to
    the other half."""
    inner = LM.decode_step

    def half(self, params, rt, caches, tokens=None, active=None, **kw):
        logits, c = inner(self, params, rt, caches, tokens=tokens,
                          active=active, **kw)
        b = logits.shape[0]
        h = b // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, c
    monkeypatch.setattr(LM, "decode_step", half)


def _token_altered(monkeypatch, cfg):
    """Every row's token of every third decode step altered where the
    engine picks it."""
    inner = ServeEngine._select
    calls = {"n": 0}

    def select(logits, *a, **k):
        tok, draws = inner(logits, *a, **k)
        calls["n"] += 1
        if tok.shape[0] > 1 and calls["n"] % 3 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok, draws
    monkeypatch.setattr(ServeEngine, "_select", staticmethod(select))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cfg,mix,name", CELLS, ids=IDS)
def test_broken_timed_path_is_not_correct(monkeypatch, cfg, mix, name, fault):
    FAULTS[fault](monkeypatch, cfg)
    res = T.run(cfg, mix, name)
    assert not res["correct"], res["readings"]
