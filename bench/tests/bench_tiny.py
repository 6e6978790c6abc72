"""Tiny cells for the benchmark's CPU tests: the configurations' families
at a few layers of width 64, the three traffic shapes at a few requests."""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (ROOT / "src", BENCH):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TIERS = {"8/8": [8, 8], "4/4": [4, 4], "2/2": [2, 2]}

QWEN = dict(name="tiny-qwen3", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=60000, qk_norm=True, rope_theta=10000.0,
            rms_norm_eps=1e-6, tie_embeddings=False, store="planes",
            tiers=TIERS)
MAMBA = dict(name="tiny-mamba2", family="ssm", ssm=True, num_layers=2,
             d_model=64, num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
             vocab_size=60000, ssm_state=16, ssm_headdim=16, ssm_expand=2,
             ssm_conv=4, ssm_chunk=8, rms_norm_eps=1e-6,
             tie_embeddings=True, init=dict(embed_std=0.02),
             store="planes", tiers=TIERS)
CLOSED = dict(loop="closed", clients=6, residual_start=True, block=6,
              prompt=dict(median=12, sigma=0.5, min=4, max=24),
              output=dict(median=20, sigma=0.3, min=10, max=30),
              tiers={"8/8": 1, "4/4": 1, "2/2": 1},
              engine=dict(max_batch=6, max_len=64, decode_chunk=4,
                          prompt_bucket=8),
              check=dict(per_tier=2))
OPEN = dict(loop="open", rate_per_s=8.0, warmup_s=0.3, block=16,
            prompt=dict(median=16, sigma=0.6, min=4, max=40),
            output=dict(median=6, sigma=0.5, min=2, max=12),
            tiers={"8/8": 1, "4/4": 1, "2/2": 1},
            engine=dict(max_batch=4, max_len=64, decode_chunk=4,
                        prompt_bucket=8),
            check=dict(per_tier=2))
E2E = [dict(name=n, unit="u") for n in ("tokens_per_s", "ttft_p75_ms",
                                        "tpot_p75_ms", "peak_mem_gb",
                                        "setup_s")]


# The widest gap a tiny cell may read.  Two layers of width 64 spread their
# logits less than the full models do, so the cells' own limits (set from
# full-size readings, limits/*.json) would pass the tiny control: at this
# size the program reads at most 0.01 and the control 1.9 or more.
TINY_GAP_LIMIT = 0.5


def limits(cell_name: str) -> dict:
    """A real cell's limits (its file), the gap's scaled to the tiny size."""
    import json
    lim = json.loads((BENCH / "limits" / f"{cell_name}.json")
                     .read_text())["limits"]
    return dict(lim, gap=TINY_GAP_LIMIT)


def run(cfg, mix, cell_name, seed=2**31 + 77, seconds=1.0, control=False):
    import time

    import torch
    from benchlib import cell
    c = cell.Cell("tiny", cfg, mix, limits(cell_name), E2E, [])
    return cell.run(c, seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), grace_s=5.0, control=control)
