"""Architecture configuration schema (port of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm: bool = False
    attn_every: int = 0
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # modality frontend (stubbed: precomputed embeddings)
    frontend: str = "none"
    dtype_str: str = "bfloat16"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype_str]

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return -(-self.vocab_size // 256) * 256

    def period_pattern(self) -> Tuple[Tuple[str, Optional[str]], ...]:
        """Per-period (mixer, ff) layer pattern.  mixer in {attn, mamba};
        ff in {mlp, moe, None}."""
        if self.ssm and self.attn_every == 0:
            return (("mamba", None),)
        if self.attn_every > 0:
            pat = []
            for i in range(self.attn_every):
                mixer = "attn" if i == self.attn_every - 1 else "mamba"
                ff = "moe" if (self.moe and i % self.moe_every
                               == self.moe_every - 1) else "mlp"
                pat.append((mixer, ff))
            return tuple(pat)
        if self.moe:
            return tuple(("attn", "moe" if i == self.moe_every - 1 else "mlp")
                         for i in range(self.moe_every))
        return (("attn", "mlp"),)

    @property
    def n_periods(self) -> int:
        p = len(self.period_pattern())
        assert self.num_layers % p == 0, (self.num_layers, p)
        return self.num_layers // p

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is O(1)/O(layers) per token (SSM or
        hybrid with mostly-SSM layers)."""
        return self.ssm or self.attn_every > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count (the reference's formula)."""
        d, dh = self.d_model, self.head_dim or 0
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for mixer, ff in self.period_pattern() * self.n_periods:
            if mixer == "attn":
                n += d * (self.num_heads * dh) + 2 * d * (self.num_kv_heads * dh) \
                    + (self.num_heads * dh) * d
            else:
                di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + hh) + di * d   # in_proj + out_proj
                n += (di + 2 * ns) * self.ssm_conv + 2 * hh + di  # conv, A, dt, D
            if ff == "mlp":
                n += 3 * d * self.d_ff
            elif ff == "moe":
                n += d * self.num_experts  # router
                n += self.num_experts * 3 * d * self.d_ff
                if self.shared_expert:
                    n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        n_moe_layers = sum(1 for _, ff in self.period_pattern() * self.n_periods
                           if ff == "moe")
        inactive = self.num_experts - self.experts_per_token
        return self.param_count() - n_moe_layers * inactive * 3 \
            * self.d_model * self.d_ff

    def quant_layer_macs(self) -> "dict[str, int]":
        """MACs per decoded token of every quantized projection, keyed by
        its policy layer name (``layers.pos{i}.<block>.<proj>``, plus
        ``lm_head``); a name covers all ``n_periods`` instances.  MoE
        projections count the ``experts_per_token`` routed experts only;
        routers, convs and tied embeddings are not quantized.  What
        ``SLOPolicy`` and ``hwmodel.energy`` price a schedule's tiers with."""
        d, dh, n = self.d_model, self.head_dim or 0, self.n_periods
        macs: "dict[str, int]" = {}
        for i, (mixer, ff) in enumerate(self.period_pattern()):
            base = f"layers.pos{i}"
            if mixer == "attn":
                macs[f"{base}.attn.q_proj"] = n * d * self.num_heads * dh
                macs[f"{base}.attn.k_proj"] = n * d * self.num_kv_heads * dh
                macs[f"{base}.attn.v_proj"] = n * d * self.num_kv_heads * dh
                macs[f"{base}.attn.o_proj"] = n * self.num_heads * dh * d
            else:
                di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
                macs[f"{base}.mamba.in_proj"] = n * d * (2 * di + 2 * ns + hh)
                macs[f"{base}.mamba.out_proj"] = n * di * d
            if ff == "mlp":
                macs[f"{base}.mlp.gate_proj"] = n * d * self.d_ff
                macs[f"{base}.mlp.up_proj"] = n * d * self.d_ff
                macs[f"{base}.mlp.down_proj"] = n * self.d_ff * d
            elif ff == "moe":
                k = self.experts_per_token
                macs[f"{base}.moe.gate_proj"] = n * k * d * self.d_ff
                macs[f"{base}.moe.up_proj"] = n * k * d * self.d_ff
                macs[f"{base}.moe.down_proj"] = n * k * self.d_ff * d
                if self.shared_expert:
                    macs[f"{base}.moe.shared.gate_proj"] = n * d * self.d_ff
                    macs[f"{base}.moe.shared.up_proj"] = n * d * self.d_ff
                    macs[f"{base}.moe.shared.down_proj"] = n * self.d_ff * d
        if not self.tie_embeddings:
            macs["lm_head"] = d * self.padded_vocab
        return macs
