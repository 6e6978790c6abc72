"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887.
Mamba+attention 1:7 interleave (1 attn per 8-layer period), MoE 16e top-2
on every other layer."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    moe=True, num_experts=16, experts_per_token=2, moe_every=2,
    ssm=True, attn_every=8, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_chunk=128,
)
