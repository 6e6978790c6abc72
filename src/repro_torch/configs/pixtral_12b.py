"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409.
Mistral-Nemo backbone (head_dim 128); pixtral-ViT frontend STUBBED: the
input_specs provide precomputed patch embeddings [B, S, d_model]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    frontend="vision",
)
