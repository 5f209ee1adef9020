"""Mamba2-780M — SSD (state-space duality), attention-free.  [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # mamba2 blocks only, no separate FFN
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256, d_conv=4),
)
