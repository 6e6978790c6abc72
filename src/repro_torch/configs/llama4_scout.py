"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.
MoE 16e top-1 with shared expert, early fusion (frontend stubbed per spec)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    moe=True, num_experts=16, experts_per_token=1, moe_every=1,
    shared_expert=True,
)
