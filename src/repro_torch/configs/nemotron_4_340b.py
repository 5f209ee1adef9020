"""Nemotron-4-340B — GQA, squared-ReLU (non-gated) FFN.  [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,              # 18432 / 96
    d_ff=73728,
    vocab_size=256000,
    ffn_kind="squared_relu",
    attention="full",
)
