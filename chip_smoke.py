#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py              # every phase, on one CUDA card

Phases, in order (any failure exits non-zero and prints no result line):

1. build    nvcc builds the four kernels from ``src/repro_torch/kernels/csrc``
            into ``build/kernels/``; prints the build seconds and the card.
2. parity   each kernel against its plain PyTorch version at the serving
            shapes (M in {8, 64}; K=4096 -> N in {4096, 1024, 12288, 152064};
            K=12288 -> N=4096) and one ragged shape (M=5, K=4100, N=1000):
            bit-equal, tolerance 0.
3. mixed    serves full-width qwen3-8b (seeded random weights made on the
            card layer by layer, each layer's float weights freed once its
            superplane store is prepared) with tiers 8/8 4/4 2/2 through the
            ``cuda`` backend; counts every kernel launch of that run, then
            replays the same requests through the plain ``decomposed``
            backend on the same store, which must launch no kernel, and
            requires identical token streams.
4. fixed    the quickstart form, --w-bits 4 --kv-bits 8 (LSB-first planes,
            int8 KV), at full width with the depth cut to 4 layers; the
            ``cuda`` engine's streams must equal the ``decomposed`` one's.
5. times    median CUDA-event time of each kernel at its serving shapes,
            beside its bound on this card, its plain version's time and,
            where one PyTorch call computes the same function, that call's.

The script takes no arguments.  The last line of standard output is
``{"ok": true, "device": {...}}``; the one before it the card's name and
power limit, and the one before that the kernel summary.
"""
from __future__ import annotations

import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
# name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "act_quant": ("src/repro_torch/kernels/csrc/act_quant.cu",
                  "src/repro/kernels/act_quant.py:46"),
    "act_quant_rows": ("src/repro_torch/kernels/csrc/act_quant.cu",
                       "src/repro/kernels/act_quant.py:91"),
    "bitserial_matmul": ("src/repro_torch/kernels/csrc/bitserial_matmul.cu",
                         "src/repro/kernels/bitserial_matmul.py:84"),
    "grouped_dequant_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                               "src/repro/kernels/grouped_matmul.py:203"),
}
GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (4096, 152064),
               (12288, 4096))


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built in {secs:.1f}s -> {_build.build_info['path']}")
    for src, text in sorted(dict(_build.build_info.get("ptxas", {})).items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[build] card: {card}")
    return {"build_seconds": secs, "card": card}


# --------------------------------------------------------------- phase 2
def _inputs(m: int, k: int, n: int, gen):
    import torch
    from repro_torch.core import decompose
    q8 = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda",
                       generator=gen)
    planes = decompose.decompose_superplanes(q8).contiguous()
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    return x, planes


def _mixed_layout(m: int):
    """Three tier groups (8/8, 4/4, 2/2) covering m rows."""
    a = (m + 2) // 3
    b = (m - a + 1) // 2
    return ((a, 4), (b, 2), (m - a - b, 1))


def _grouped_args(m: int, n: int, gen):
    import numpy as np
    import torch
    from repro_torch.core import decompose
    layout = _mixed_layout(m)
    mult = torch.from_numpy(decompose.prefix_multipliers(layout)).cuda()
    xs = torch.rand((m, 1), device="cuda", generator=gen) * 1e-2 + 1e-4
    base = torch.rand((1, n), device="cuda", generator=gen) * 1e-2 + 1e-5
    ws = torch.cat([base, base * 16.0, base * 64.0]).contiguous()
    rg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32),
                                    [r for r, _ in layout])).cuda()
    return mult, xs, ws, rg


def phase_parity() -> dict:
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {name: 0.0 for name in KERNELS}
    checks = {name: 0 for name in KERNELS}

    def hold(name: str, got, want) -> None:
        checks[name] += 1
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        diff = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to its plain "
                                 f"version (max abs err {diff})")

    shapes = [(m, k, n) for m in (8, 64) for k, n in GEMM_SHAPES]
    shapes.append((5, 4100, 1000))
    for k in sorted({k for _, k, _ in shapes}):
        for m in (5, 8, 64):
            x = torch.randn((m, k), device="cuda", generator=gen) * 3.0
            for bits, signed in ((8, True), (4, True), (2, True), (8, False),
                                 (4, False)):
                xin = x.abs() if not signed else x
                got = aq.act_quant(xin, bits=bits, signed=signed)
                want = ref.act_quant_ref(xin, bits=bits, signed=signed)
                hold("act_quant", got[0], want[0])
                hold("act_quant", got[1], want[1])
            qmax = torch.tensor([[127.0], [7.0], [1.0]], device="cuda"
                                ).repeat(m, 1)[:m].contiguous()
            got = aq.act_quant_rows(x, qmax)
            want = ref.act_quant_rows_ref(x, qmax)
            hold("act_quant_rows", got[0], want[0])
            hold("act_quant_rows", got[1], want[1])
    sync()
    for m, k, n in shapes:
        x, planes = _inputs(m, k, n, gen)
        for p in (1, 2, 3, 4):
            pre = planes[:p]
            for shifts in (decompose.prefix_shifts(p),
                           tuple(2 * c for c in range(p))):
                hold("bitserial_matmul", bsm.bitserial_matmul(x, pre, shifts),
                     ref.bitserial_matmul_ref(x, pre, shifts))
        mult, xs, ws, rg = _grouped_args(m, n, gen)
        hold("grouped_dequant_matmul",
             gmm.grouped_dequant_matmul(x, planes, mult, xs, ws, rg),
             ref.grouped_dequant_matmul_ref(x, planes, mult, xs, ws, rg))
        del x, planes
        sync()
        torch.cuda.empty_cache()
    log("[parity] tolerance 0 (bit-equal): " + ", ".join(
        f"{k}: {checks[k]} cases" for k in KERNELS))
    return {"max_abs_err": err}


# ----------------------------------------------------------- phases 3, 4
def _requests(n: int, vocab: int, max_new: int, tiers, seed: int):
    import numpy as np
    from repro_torch.serve.request import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, size=int(rng.integers(16, 65)),
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=max_new,
                    tier=None if tiers is None else tiers[i % len(tiers)])
            for i in range(n)]


def _serve(engine, reqs, label: str) -> dict:
    """Serve ``reqs``, counting the kernel launches of exactly this run."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.reset_peak_memory_stats()
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    toks = sum(len(v) for v in out.values())
    res = {
        "requests": len(reqs), "tokens": toks, "wall_s": wall,
        "prefills": st.prefills, "decode_steps": st.decode_steps,
        "decode_chunks": st.decode_chunks,
        "decode_tokens_per_s": st.decode_slot_steps / st.decode_seconds,
        "mean_decode_step_ms": 1e3 * st.decode_seconds / st.decode_steps,
        "prefill_s": st.prefill_seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    log(f"[{label}] " + json.dumps(res, sort_keys=True))
    return {"stats": res, "tokens": out}


def _check_plain(label: str, ref: dict, res: dict) -> None:
    """The plain replay launched no kernel and gave the same streams."""
    if any(ref["stats"]["launches"].values()):
        raise AssertionError(f"{label}: the plain backend launched kernels: "
                             f"{ref['stats']['launches']}")
    if ref["tokens"] != res["tokens"]:
        raise AssertionError(f"{label}: cuda streams differ from the plain "
                             "backend's")
    log(f"[{label}] {len(res['tokens'])} streams identical to the plain "
        "decomposed backend's, which launched no kernel")


def _check_streams(label: str, out, reqs, vocab: int) -> None:
    for r in reqs:
        toks = out[r.uid]
        if len(toks) != r.max_new_tokens:
            raise AssertionError(f"{label}: uid {r.uid} got {len(toks)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: uid {r.uid} token out of range")


def _build_model(layers: int, policy, superplane: bool, seed: int):
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import engine as engine_mod
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=layers)
    model = LM(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device="cuda", prepare=lambda tree, prefix:
                        engine_mod.prepare_tree(tree, policy, prefix=prefix,
                                                superplane=superplane))
    sync()
    log(f"[model] qwen3-8b width {cfg.d_model}, {cfg.num_heads} heads, "
        f"{cfg.num_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}, {layers} layers: initialised + prepared in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    return cfg, model, params


def phase_mixed() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    tiers = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
    sched = uniform_schedule(tiers, backend="cuda")
    cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                      sched.prepare_policy(),
                                      superplane=True, seed=0)
    reqs = _requests(9, cfg.vocab_size, 16, list(tiers), seed=1)
    kw = dict(max_batch=8, max_len=256, decode_chunk=8, device="cuda")
    eng = engine_mod.ServeEngine(model, params, Runtime(
        policy=sched.policy_for(), schedule=sched), **kw)
    calls = engine_mod.PREPARE_CALLS
    res = _serve(eng, reqs, "mixed")
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("prepare_params ran after engine construction")
    _check_streams("mixed", res["tokens"], reqs, cfg.padded_vocab)
    missing = [k for k, v in res["stats"]["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if eng.stats.mixed_tier_chunks == 0:
        raise AssertionError("no decode chunk mixed tiers")
    del eng
    plain = uniform_schedule(tiers, backend="decomposed")
    ref_eng = engine_mod.ServeEngine(model, params, Runtime(
        policy=plain.policy_for(), schedule=plain), **kw)
    _check_plain("mixed", _serve(ref_eng, reqs, "mixed-plain"), res)
    return res["stats"]


def phase_fixed() -> dict:
    from repro_torch.core.policy import uniform_policy
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    policy = uniform_policy(4, 8, backend="cuda")
    cfg, model, params = _build_model(4, policy, superplane=False, seed=2)
    log("[fixed] depth cut: 4 of qwen3-8b's 36 layers")
    reqs = _requests(6, cfg.vocab_size, 16, None, seed=3)
    kw = dict(max_batch=4, max_len=256, kv_bits=8, decode_chunk=8,
              device="cuda")
    eng = engine_mod.ServeEngine(model, params, Runtime(policy=policy), **kw)
    res = _serve(eng, reqs, "fixed")
    _check_streams("fixed", res["tokens"], reqs, cfg.padded_vocab)
    del eng
    ref_eng = engine_mod.ServeEngine(
        model, params, Runtime(policy=policy.with_backend("decomposed")), **kw)
    _check_plain("fixed", _serve(ref_eng, reqs, "fixed-plain"), res)
    return res["stats"]


# --------------------------------------------------------------- phase 5
def _time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_times() -> dict:
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []
    log("[times] library_ms: torch._int_mm on the recomposed 8-bit weight for "
        "bitserial_matmul at P=4, M=64 (it needs M > 16); no single PyTorch "
        "call computes act_quant, act_quant_rows or grouped_dequant_matmul")

    def row(kernel, shape, fn, plain, nbytes, ops, library=None):
        ms = _time_ms(fn)
        plain_ms = _time_ms(plain, reps=5, warm=1)
        lib_ms = _time_ms(library) if library is not None else None
        bound, by = _bound_ms(nbytes, ops)
        r = {"name": kernel, "shape": shape, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        log("[times] " + json.dumps(r))
        rows.append(r)

    for m, k in ((8, 4096), (64, 4096), (8, 12288), (64, 12288)):
        x = torch.randn((m, k), device="cuda", generator=gen)
        qmax = torch.full((m, 1), 7.0, device="cuda")
        nbytes = m * k * 5 + m * 4
        row("act_quant", f"M={m} K={k} bits=8",
            lambda: aq.act_quant(x), lambda: ref.act_quant_ref(x), nbytes, 0)
        row("act_quant_rows", f"M={m} K={k}",
            lambda: aq.act_quant_rows(x, qmax),
            lambda: ref.act_quant_rows_ref(x, qmax), nbytes + m * 4, 0)
    for m in (8, 64):
        for k, n in GEMM_SHAPES:
            x, planes = _inputs(m, k, n, gen)
            for p in (4, 2, 1):
                pre = planes[:p]
                sh = decompose.prefix_shifts(p)
                lib = None
                if p == 4 and m > 16:
                    w8 = decompose.recompose_weights(
                        planes.flip(0), 8).to(torch.int8).contiguous()
                    lib = (lambda x=x, w8=w8: torch._int_mm(x, w8))
                row("bitserial_matmul", f"M={m} K={k} N={n} P={p}",
                    lambda pre=pre, sh=sh: bsm.bitserial_matmul(x, pre, sh),
                    lambda pre=pre, sh=sh: ref.bitserial_matmul_ref(x, pre, sh),
                    m * k + p * k * n + 4 * m * n, 2.0 * m * k * n * p, lib)
            mult, xs, ws, rg = _grouped_args(m, n, gen)
            row("grouped_dequant_matmul", f"M={m} K={k} N={n} Pmax=4",
                lambda: gmm.grouped_dequant_matmul(x, planes, mult, xs, ws, rg),
                lambda: ref.grouped_dequant_matmul_ref(x, planes, mult, xs,
                                                       ws, rg),
                m * k + 4 * k * n + m * 16 + m * 4 + 3 * n * 4 + m * 4
                + 2 * m * n, 2.0 * m * k * n * 4)
            del x, planes
            torch.cuda.empty_cache()
    return {"rows": rows}


# ------------------------------------------------------------------ main
# The shape each kernel's summary entry reports: its heaviest serving shape
# on the path that runs it (prefill M=64 for act_quant/bitserial_matmul,
# mixed-tier decode M=8 for act_quant_rows/grouped_dequant_matmul).
SUMMARY_SHAPE = {
    "act_quant": "M=64 K=4096 bits=8",
    "act_quant_rows": "M=8 K=4096",
    "bitserial_matmul": "M=64 K=4096 N=12288 P=4",
    "grouped_dequant_matmul": "M=8 K=4096 N=12288 Pmax=4",
}


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    out = {}
    t0 = time.perf_counter()
    for phase, run in (("build", phase_build), ("parity", phase_parity),
                       ("mixed", phase_mixed), ("fixed", phase_fixed),
                       ("times", phase_times)):
        t = time.perf_counter()
        out[phase] = run()
        sync()
        # Engines and their request handles form reference cycles: collect
        # them so the next phase starts with the card's memory free.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{phase}] done in {time.perf_counter() - t:.1f}s")
    log(f"[all] {time.perf_counter() - t0:.1f}s")
    by_shape = {(r["name"], r["shape"]): r for r in out["times"]["rows"]}
    kernels = []
    for name, (src, tpu) in KERNELS.items():
        t = by_shape[(name, SUMMARY_SHAPE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": out["mixed"]["launches"][name],
            "max_abs_err": out["parity"]["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(out["build"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
