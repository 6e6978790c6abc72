"""The paper's headline trade-off on the PyTorch port: per-layer precision
against quality against energy (the twin of ``examples/precision_sweep.py``).

Trains a small LM briefly in 8-bit QAT, then sweeps uniform and mixed
policies, reporting next-token CE on the integer serving path and the
hwmodel energy per MAC — the software equivalent of the paper's
MobileNetV2 experiment (§IV).  On a CUDA card every policy's forward runs
the hand-written kernels (activation quantization, then the plane GEMM
over the fixed-width Table-I planes, 512 rows a projection); on the CPU,
their plain versions.

    PYTHONPATH=src python examples/precision_sweep_torch.py          # the card
    PYTHONPATH=src python examples/precision_sweep_torch.py --device cpu
"""
import argparse
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.policy import (LayerPrecision, PrecisionPolicy,
                                     uniform_policy)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import integer_backend, resolve_device
from repro_torch.hwmodel import energy
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import prepare_params
from repro_torch.train import optimizer as optim
from repro_torch.train.step import make_loss_fn, make_train_step

TRAIN_STEPS = 60
SEQ_LEN, BATCH = 32, 16
HELD_OUT_STEP = 10_000


def policies(backend: str) -> Dict[str, PrecisionPolicy]:
    """The swept policies, every one on ``backend``."""
    return {
        "w8a8 uniform": uniform_policy(8, 8, backend=backend),
        "w6a8 uniform": uniform_policy(6, 8, backend=backend),
        "w4a8 uniform": uniform_policy(4, 8, backend=backend),
        "w3a8 uniform": uniform_policy(3, 8, backend=backend),
        "w2a8 uniform": uniform_policy(2, 8, backend=backend),
        "mixed attn6/mlp4": PrecisionPolicy(rules={
            "layers.*.attn.*": LayerPrecision(6, 8, backend=backend),
            "layers.*.mlp.*": LayerPrecision(4, 8, backend=backend),
        }, default=LayerPrecision(8, 8, backend=backend)),
    }


def data_for(vocab_size: int) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab_size=vocab_size, seq_len=SEQ_LEN,
                                  global_batch=BATCH))


def batch_on(data: SyntheticLM, step: int,
             device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch(step).items()}


def pj_per_mac(name: str, pol: PrecisionPolicy) -> float:
    """The hwmodel's energy per MAC of a policy (pJ); the mixed policy's is
    a 0.45 / 0.55 mix of its attention and MLP widths."""
    if "mixed" in name:
        return 0.45 * energy.energy_per_mac_j(6, 8) * 1e12 \
            + 0.55 * energy.energy_per_mac_j(4, 8) * 1e12
    bits = pol.lookup("layers.pos0.mlp.up_proj").w_bits
    return energy.energy_per_mac_j(bits, 8) * 1e12


def evaluate(model: LM, params: Any, held: Dict[str, torch.Tensor],
             backend: str, say: Callable[[str], None] = print,
             names=None) -> Dict[str, Dict[str, float]]:
    """Each policy's serve-mode CE of float ``params`` on ``held``: the
    weights prepared into fixed-width planes (``prepare_params``), the
    loss through the integer path.  Prints the table through ``say``.
    Returns {policy: {"ce", "pj", "seconds"}}."""
    out = {}
    say(f"{'policy':18s} {'CE':>7s} {'pJ/MAC':>8s} {'rel energy':>10s}")
    e8 = energy.energy_per_mac_j(8, 8) * 1e12
    for name, pol in policies(backend).items():
        if names is not None and name not in names:
            continue
        t0 = time.perf_counter()
        with torch.no_grad():
            prepared, _ = prepare_params(params, pol, model)
            rt = Runtime(policy=pol, moe_dropless=True)
            ce = float(make_loss_fn(model, rt)(prepared, held)[0])
        del prepared
        pj = pj_per_mac(name, pol)
        out[name] = {"ce": ce, "pj": pj,
                     "seconds": time.perf_counter() - t0}
        say(f"{name:18s} {ce:7.3f} {pj:8.3f} {pj/e8:9.1%}")
    return out


def run(params: Any = None, device: Any = None,
        backend: Optional[str] = None, seed: int = 0,
        steps: int = TRAIN_STEPS) -> Dict[str, Any]:
    """Train reduced qwen3-8b ``steps`` steps (w8a8 ``fake_quant``) from
    ``params`` (default: weights drawn from a generator seeded ``seed``) on
    ``device`` (default cuda), then sweep the policies on ``backend``.
    Returns ``lines`` (what :func:`main` prints), ``train_ce`` (the last
    step's), ``sweep`` (see :func:`evaluate`) and the trained
    ``params``."""
    dev = resolve_device(device)
    backend = backend or integer_backend(dev)
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    lines = []

    # Train briefly in 8-bit QAT so quality differences are meaningful.
    rt_train = Runtime(policy=uniform_policy(8, 8, backend="fake_quant"))
    data = data_for(cfg.vocab_size)
    ocfg = optim.OptConfig(lr=1e-2, warmup_steps=5, total_steps=80,
                           weight_decay=0.0)
    step = make_train_step(model, rt_train, ocfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, device=dev)
    else:
        params = optim.tree_map(lambda t: t.to(dev), params)
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    train_ce = float("nan")
    for i in range(steps):
        state, m = step(state, batch_on(data, i, dev))
        train_ce = float(m["ce"])
    lines.append(f"trained {steps} steps, final ce={train_ce:.3f}")

    held = batch_on(data, HELD_OUT_STEP, dev)
    sweep = evaluate(model, state["params"], held, backend, lines.append)
    return {"lines": lines, "train_ce": train_ce, "sweep": sweep,
            "params": state["params"]}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
