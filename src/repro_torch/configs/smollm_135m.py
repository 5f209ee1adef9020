"""SmolLM-135M — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,               # 576 / 9
    d_ff=1536,
    vocab_size=49152,
    ffn_kind="swiglu",
    attention="full",
    tie_embeddings=True,
)
