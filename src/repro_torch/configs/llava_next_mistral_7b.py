"""LLaVA-NeXT (v1.6) Mistral-7B backbone — anyres tiling VLM.

[hf:llava-hf/llava-v1.6-mistral-7b-hf]
Backbone only per assignment: the SigLIP/CLIP-ViT vision tower + projector is a
stub; ``input_specs()`` feeds precomputed anyres patch embeddings.  Mistral uses
sliding-window attention natively (window 4096), GQA with 8 kv heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    ffn_kind="swiglu",
    attention="sliding_window",
    window=4096,
    # anyres tiling: base 336px tile -> 576 patch tokens; up to 4 tiles + base
    # = 2880 image tokens max; we provision 2880 for shape purposes.
    n_image_tokens=2880,
    rope_theta=1000000.0,
)
