"""OLMoE-1B-7B — 64-expert top-8 MoE.  [arXiv:2409.02060]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert FFN width
    vocab_size=50304,
    ffn_kind="swiglu",
    attention="full",
    moe=MoEConfig(num_experts=64, top_k=8),
)
