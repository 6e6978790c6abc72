"""starcoder2-7b [dense] — arXiv:2402.19173. GQA kv=4, RoPE."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    head_dim=128, d_ff=18432, vocab_size=49152,
    rope_theta=1e5,
)
