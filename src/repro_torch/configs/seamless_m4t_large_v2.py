"""SeamlessM4T-large v2 text/speech translation backbone — enc-dec, multimodal.

[arXiv:2308.11596]
Backbone only: the w2v-BERT speech frontend (mel + conv feature extractor) is a
stub; ``input_specs()`` feeds precomputed frame embeddings to the encoder.
24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv=16 -> MHA), ffn 8192.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=24,               # decoder layers
    n_enc_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    ffn_kind="swiglu",
    attention="full",
    n_audio_frames=1024,       # encoder-side precomputed frames for specs
)
