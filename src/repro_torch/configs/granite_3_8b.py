"""granite-3-8b [dense] — hf:ibm-granite/granite-3.0 family. GQA kv=8."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12800, vocab_size=49155,
)
