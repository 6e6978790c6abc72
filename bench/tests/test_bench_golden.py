"""The dense and SSM cells read what they read before the harness took
every family: the tiny qwen3 and mamba2 weights and reference logits hash
to the digests written before that change, and the counts at the full
``qwen3-8b.json`` and ``mamba2-1.3b.json`` equal the numbers written then,
bit for bit."""
import hashlib
import json

import pytest
import torch

import bench_tiny as T
from benchlib import counts, reference, weights

SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(tree) -> str:
    """sha256 over every tensor of a params tree: its key path, dtype,
    shape and bytes, dicts in key order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            t = node.detach().contiguous()
            h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            h.update(raw.numpy().tobytes())
    walk(tree, "")
    return h.hexdigest()


WEIGHTS = {
    "qwen3":
        "e9acdcfdc815f0cfd6bbbe180486c6416dc0b8de43e2cbaf2fda11b597aefb91",
    "mamba2":
        "dba4314e1a5aa608d6dab6b9d999bfa09c6c6662d79f37d464eca001952c89fb",
}
LOGITS = {
    "qwen3":
        "cf8a07011a63760eaba38e9955814253ee73516d632f75d43d231c1456f402ca",
    "mamba2":
        "55c0da7eefe725ce503be1466fca408c7a64e9dff6e136f246c031275885369c",
}
TINY = {"qwen3": T.QWEN, "mamba2": T.MAMBA}


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_weights_are_the_parents(name):
    cfg = TINY[name]
    assert _digest(weights.make_params(cfg, SEED, torch.device("cpu"))) \
        == WEIGHTS[name]


def _sequences():
    g = torch.Generator().manual_seed(5)
    lens, plens = (14, 9, 21, 6), (8, 5, 12, 3)
    seqs = [torch.randint(0, 60000, (n,), generator=g) for n in lens]
    tiers = [(8, 8), (4, 4), (2, 2), (1, 2)]
    first = [p - 1 for p in plens]
    return seqs, list(plens), tiers, first


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_reference_logits_are_the_parents(name):
    ref = reference.Reference(TINY[name], SEED, torch.device("cpu"))
    with torch.no_grad():
        out = ref.logits(*_sequences())
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == LOGITS[name]


def _full(name):
    return json.loads((T.BENCH / "configs" / f"{name}.json").read_text())


def count_readings(cfg):
    """Every count function at the arguments the readers give it."""
    out = {}
    for c in (1, 192, 2048):
        out[f"token_ops/{c}"] = counts.token_ops(cfg, c)
    for n in (1, 1024, 3072):
        out[f"prompt_ops/{n}"] = counts.prompt_ops(cfg, n)
    for rows, pmax, groups, packed in ((64, 4, 3, False), (128, 4, 3, False),
                                       (8, 2, 2, True)):
        out[f"decode_step_k4/{rows}/{pmax}/{groups}/{packed}"] = \
            counts.decode_step_k4(cfg, rows, pmax, groups, packed)
    for rows, planes, packed, head in ((1024, 4, False, 1), (64, 1, False, 64),
                                       (512, 2, True, 0)):
        out[f"plane_gemms/{rows}/{planes}/{packed}/{head}"] = \
            counts.plane_gemms(cfg, rows, planes, packed, head)
    return out


COUNTS = {
    "qwen3-8b": {
        "token_ops/1": 15137832960.0,
        "token_ops/192": 15250489344.0,
        "token_ops/2048": 16345202688.0,
        "prompt_ops/1": 15137832960.0,
        "prompt_ops/1024": 14535717027840.0,
        "prompt_ops/3072": 45460085538816.0,
        "decode_step_k4/64/4/3/False": 0.00912760511044776,
        "decode_step_k4/128/4/3/False": 0.009212487527164179,
        "decode_step_k4/8/2/2/True": 0.0022736038973134327,
        "plane_gemms/1024/4/False/1": 0.011155779400597015,
        "plane_gemms/64/1/False/64": 0.0024033909683582088,
        "plane_gemms/512/2/True/0": 0.0036180025244467503,
    },
    "mamba2-1.3b": {
        "token_ops/1": 2787737600.0,
        "token_ops/192": 2787737600.0,
        "token_ops/2048": 2787737600.0,
        "prompt_ops/1": 2787737600.0,
        "prompt_ops/1024": 2643322732544.0,
        "prompt_ops/3072": 7929555058688.0,
        "decode_step_k4/64/4/3/False": 0.001506761896119403,
        "decode_step_k4/128/4/3/False": 0.001531807407761194,
        "decode_step_k4/8/2/2/True": 0.00037431448835820896,
        "plane_gemms/1024/4/False/1": 0.002189802297313433,
        "plane_gemms/64/1/False/64": 0.000414344023880597,
        "plane_gemms/512/2/True/0": 0.0007249259749253731,
    },
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_full_size_counts_are_the_parents(name):
    got = count_readings(_full(name))
    assert got == COUNTS[name]
