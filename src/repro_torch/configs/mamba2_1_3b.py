"""mamba2-1.3b [ssm] — arXiv:2405.21060. SSD (state-space duality),
attention-free, ssm_state=128."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    head_dim=0, d_ff=0, vocab_size=50280,
    ssm=True, ssm_state=128, ssm_headdim=64, ssm_expand=2,
)
