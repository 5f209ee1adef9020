"""Nemotron-4-15B — GQA, squared-ReLU FFN.  [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,              # 6144 / 48
    d_ff=24576,
    vocab_size=256000,
    ffn_kind="squared_relu",
    attention="full",
)
