"""Long-context decode with an SSM on the PyTorch port: O(1) state per
token against a growing KV cache (the twin of
``examples/long_context_ssm.py``).

Decodes step by step with a mamba2-family model: the recurrent state is a
fixed [H, N, P] tensor whatever the context length, while an attention
model's KV cache grows linearly (and its per-token read cost with it).  On
a CUDA card every projection runs the hand-written kernels (activation
quantization and the plane GEMM at M = 2 rows); on the CPU, their plain
versions.

    PYTHONPATH=src python examples/long_context_ssm_torch.py         # the card
    PYTHONPATH=src python examples/long_context_ssm_torch.py --device cpu
"""
import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.policy import uniform_policy
from repro_torch.device import integer_backend, resolve_device
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM

STEPS = 256
BATCH = 2


def state_bytes(cache: Any) -> int:
    """Bytes of every tensor of a model's cache list."""
    return sum(t.numel() * t.element_size()
               for layer in cache for c in layer.values()
               for t in c.tensors() if t is not None)


def run(params: Any = None, device: Any = None,
        backend: Optional[str] = None, seed: int = 0,
        steps: int = STEPS) -> Dict[str, Any]:
    """``steps`` greedy decode steps of reduced mamba2-1.3b at batch 2 on
    ``device`` (default cuda) from ``params`` (default: weights drawn
    from a generator seeded ``seed``).  Returns ``lines`` (what
    :func:`main` prints), ``state_bytes`` and
    ``tokens`` [steps, batch] (the token fed to each step: zeros first,
    then each step's argmax)."""
    dev = resolve_device(device)
    backend = backend or integer_backend(dev)
    cfg = reduced_config("mamba2-1.3b")
    model = LM(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, device=dev)
    rt = Runtime(policy=uniform_policy(4, 8, backend=backend))
    lines = []

    b = BATCH
    # max_len is unused by SSM caches.
    cache = model.init_cache(b, max_len=8, device=dev)
    nbytes = state_bytes(cache)
    lines.append(f"SSM recurrent state: {nbytes/1e3:.1f} KB for batch={b} — "
                 "CONSTANT in context length")

    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    # Warm up (the reference compiles here).
    logits, cache = model.decode_step(params, rt, cache, tokens=tok)

    fed = []
    t0 = time.time()
    with torch.no_grad():
        for _ in range(steps):
            fed.append(tok)
            logits, cache = model.decode_step(params, rt, cache, tokens=tok)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    lines.append(f"decoded {steps} tokens x batch {b} in {dt:.2f}s "
                 f"({steps*b/dt:.0f} tok/s on {dev.type}, {backend} "
                 "backend) — flat per-token cost")

    # Contrast: attention KV for the same arch family at 500k context.
    kv_per_tok = 2 * 8 * 128 * 2          # kvh * dh * bf16 * (k+v), per layer
    lines.append(f"(an attention layer at 524288 ctx would hold "
                 f"{524288*kv_per_tok/1e9:.1f} GB KV per layer per sequence; "
                 "the mamba2 state above replaces it)")
    tokens = torch.cat(fed, dim=1).T.cpu() if fed else torch.zeros((0, b))
    return {"lines": lines, "state_bytes": nbytes, "tokens": tokens}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    print("\n".join(res["lines"]))
    return res


if __name__ == "__main__":
    main()
