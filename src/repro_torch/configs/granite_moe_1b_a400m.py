"""Granite-3.0-1B-A400M — 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,               # 1024 / 16
    d_ff=512,                  # per-expert width
    vocab_size=49155,
    ffn_kind="swiglu",
    attention="full",
    moe=MoEConfig(num_experts=32, top_k=8),
)
