"""Hymba-1.5B — hybrid: parallel attention + Mamba heads per block.
[arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,               # 25 * 64 = 1600
    d_ff=5504,
    vocab_size=32001,
    ffn_kind="swiglu",
    attention="full",          # hybrid block runs attention + SSM in parallel
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256, d_conv=4),
)
