"""Continuous-batching serving with offline-quantized (plane-decomposed)
weights and an int8 KV cache on the PyTorch port (the twin of
``examples/serve_quantized.py``).  Requests with heterogeneous prompt
lengths and decode budgets stream through a fixed-slot cache arena: a slot
frees the step its budget is exhausted and the next request is prefilled
into it without touching the other slots.  On a CUDA card every
projection runs the hand-written kernels (activation quantization, then
the plane GEMM); on the CPU, their plain versions.

    PYTHONPATH=src python examples/serve_quantized_torch.py          # the card
    PYTHONPATH=src python examples/serve_quantized_torch.py --device cpu
"""
import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.policy import uniform_policy
from repro_torch.device import integer_backend, resolve_device
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request


def run(params: Any = None, device: Any = None,
        backend: Optional[str] = None, seed: int = 0) -> Dict[str, Any]:
    """Serve the eight requests on ``device`` (default cuda) from
    ``params`` (default: weights drawn from a generator seeded ``seed``).
    Returns ``lines`` (what :func:`main` prints), the streams ``results``
    {uid: tokens}, the engine's ``stats`` and ``quantized`` (the count of
    prepared weights)."""
    dev = resolve_device(device)
    backend = backend or integer_backend(dev)
    cfg = reduced_config("qwen3-8b")
    model = LM(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, device=dev)
    lines = []

    # The engine performs the weight preload itself: float params ->
    # Table-I planes, prepared once at construction.
    policy = uniform_policy(4, 8, backend=backend)
    rt = Runtime(policy=policy, moe_dropless=True)
    engine = ServeEngine(model, params, rt, max_batch=4, max_len=64,
                         kv_bits=8, decode_chunk=8,   # int8 KV cache
                         device=dev)
    lines.append(f"quantized {len(engine.quantized_paths)} projection "
                 "weights to 4-bit planes")

    rng = np.random.default_rng(1)
    requests = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           size=4 + i % 5).astype(np.int32),
                max_new_tokens=2 + 3 * (i % 4))
        for i in range(8)
    ]
    # The streaming API: submit returns a handle per request immediately;
    # each step() emits TokenEvents as slots produce tokens.  (The blocking
    # form `engine.run(requests)` is a thin wrapper over this same loop.)
    t0 = time.time()
    handles = [engine.submit(r) for r in requests]
    handles[0].on_token(lambda ev: lines.append(
        f"  [stream] req 0 token {ev.index}: {ev.token}"))
    while engine.has_work:
        engine.step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    results = {h.uid: h.tokens for h in handles}
    dt = time.time() - t0
    toks = sum(len(v) for v in results.values())
    st = engine.stats
    lines.append(f"served {len(requests)} requests / {toks} tokens "
                 f"in {dt:.2f}s ({toks/dt:.1f} tok/s on {dev.type}, "
                 f"{backend} backend)")
    lines.append(f"decode: {st.decode_steps} steps in {st.decode_chunks} "
                 f"chunk dispatches, {st.decode_slot_steps} active "
                 "slot-steps")
    for uid in sorted(results):
        lines.append(f"  req {uid}: {results[uid]}")
    return {"lines": lines, "results": results, "stats": st,
            "quantized": len(engine.quantized_paths)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
