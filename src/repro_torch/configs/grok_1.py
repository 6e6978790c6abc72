"""grok-1-314b [moe] — hf:xai-org/grok-1. 8 experts top-2."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=32768, vocab_size=131072,
    moe=True, num_experts=8, experts_per_token=2, moe_every=1,
)
