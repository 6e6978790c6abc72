"""musicgen-large [audio] — arXiv:2306.05284. Decoder-only over EnCodec
tokens (kv=32 = MHA); the EnCodec frontend is STUBBED: input_specs provide
precomputed frame embeddings [B, S, d_model]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    frontend="audio",
)
