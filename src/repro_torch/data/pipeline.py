"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``;
numpy only, a copy of the reference's generator, so both packages give
the same batches bit for bit).

Counter-based (Philox) generation keyed on (seed, step) — any batch is
reproducible from the manifest alone, so checkpoint/restore and elastic
re-sharding never lose pipeline position, and two hosts generating the same
(step, shard) agree bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # "uniform": iid tokens (throughput testing).  "arith": learnable
    # next-token structure (loss visibly decreases — used by examples/tests).
    task: str = "arith"
    embed_dim: int = 0        # >0: emit precomputed embeddings (vlm/audio stubs)


class SyntheticLM:
    """Stateless batch generator; `state` is just the step counter."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1):
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        key = np.array([(np.uint64(cfg.seed) << np.uint64(32))
                        | np.uint64(step & 0xFFFFFFFF),
                        (np.uint64(shard) << np.uint64(32))
                        | np.uint64(0xDA7A)], np.uint64)
        rng = np.random.Generator(np.random.Philox(key=key))
        if cfg.task == "uniform":
            toks = rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len + 1),
                                dtype=np.int32)
        else:
            # Arithmetic sequences mod vocab with per-row stride + 10% noise:
            # learnable by a tiny LM in a few hundred steps.
            start = rng.integers(0, cfg.vocab_size, size=(b, 1))
            stride = rng.integers(1, min(17, cfg.vocab_size), size=(b, 1))
            pos = np.arange(cfg.seq_len + 1)[None, :]
            toks = ((start + stride * pos) % cfg.vocab_size).astype(np.int32)
            noise = rng.random((b, cfg.seq_len + 1)) < 0.1
            toks = np.where(noise, rng.integers(
                0, cfg.vocab_size, size=toks.shape), toks).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.embed_dim:
            emb = rng.standard_normal(
                (b, cfg.seq_len, cfg.embed_dim), dtype=np.float32)
            out["embeds"] = emb
        return out
