"""Architecture registry: ``--arch <id>`` selectable configs (the same ten
configuration files as ``repro.configs``)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.jamba_1_5_large import CONFIG as _jamba
from repro_torch.configs.llama4_scout import CONFIG as _llama4
from repro_torch.configs.grok_1 import CONFIG as _grok
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.musicgen_large import CONFIG as _musicgen

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        _qwen3, _stablelm, _granite, _starcoder2, _jamba,
        _llama4, _grok, _mamba2, _pixtral, _musicgen,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """Small same-family config for CPU tests (the reference's reduction:
    few layers, d_model 64, vocab 512)."""
    cfg = get_config(name)
    period = len(cfg.period_pattern())
    n_layers = period * (1 if period > 1 else 2)
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        vocab_size=512,
        rope_theta=1e4,
    )
    if cfg.num_heads:
        updates.update(num_heads=4,
                       num_kv_heads=min(4, max(1, cfg.num_kv_heads // 8)),
                       head_dim=16)
        if cfg.num_kv_heads == cfg.num_heads:   # MHA archs stay MHA
            updates.update(num_kv_heads=4)
    if cfg.d_ff:
        updates.update(d_ff=128)
    if cfg.moe:
        updates.update(num_experts=4,
                       experts_per_token=min(2, cfg.experts_per_token))
    if cfg.ssm:
        updates.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
    return dataclasses.replace(cfg, **updates)
