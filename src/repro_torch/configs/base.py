"""Architecture + input-shape configuration for the repro framework.

Every assigned architecture gets one ``<id>.py`` in this package holding an
``ArchConfig`` with the exact dimensions from the assignment table (source
citation in the ``source`` field).  ``reduced()`` derives the CPU-smoke-test
variant (2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


def pad_vocab(v: int, multiple: int = 128, shards: int = 16) -> int:
    """Round vocab up so it is both MXU-aligned and divisible by the tp axis."""
    import math
    step = multiple * shards // math.gcd(multiple, shards)
    return ((v + step - 1) // step) * step


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor used for fixed-shape token dispatch (TPU-friendly).
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block configuration."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    d_conv: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation from the assignment table
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- activation/ffn style ---
    ffn_kind: str = "swiglu"         # swiglu | squared_relu
    # --- attention style ---
    attention: str = "full"          # full | sliding_window | none
    window: int = 4096               # used when attention == sliding_window
    rope_theta: float = 10000.0
    # --- optional sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (audio) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- multimodal stub frontends ---
    n_image_tokens: int = 0          # vlm: precomputed patch embeddings per sample
    n_audio_frames: int = 0          # audio: precomputed frame embeddings (encoder input)
    # --- numerics / training ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # ---------- derived ----------
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def attn_heads_or_zero(self) -> int:
        return 0 if self.attention == "none" else self.n_heads

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, V = self.d_model, self.n_layers, self.padded_vocab
        total = V * d                      # embedding
        if not self.tie_embeddings:
            total += V * d                 # lm head
        total += d                         # final norm
        per_layer = 0
        if self.attention != "none":
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            per_layer += d * qd + 2 * d * kvd + qd * d + d  # qkv,o + norm
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj produces [z, x, B, C, dt]
            zxbcdt = 2 * d_in + 2 * s.d_state + nheads
            per_layer += d * zxbcdt + (d_in + 2 * s.d_state) * s.d_conv
            per_layer += nheads * 2 + d_in  # A_log, D, dt_bias? (approx) + norm-ish
            per_layer += d_in * d + d       # out proj + norm
        if self.d_ff > 0:
            n_mats = 3 if self.ffn_kind == "swiglu" else 2
            ff = n_mats * d * self.d_ff
            if self.moe is not None:
                per_layer += self.moe.num_experts * ff + d * self.moe.num_experts
            else:
                per_layer += ff
            per_layer += d                  # ffn norm
        total += L * per_layer
        if self.enc_dec:
            # encoder layers: self-attn + ffn; decoder adds cross-attn (count in L above
            # via cross flag at model build; approximate here)
            enc_per = 0
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            enc_per += d * qd + 2 * d * kvd + qd * d + d
            n_mats = 3 if self.ffn_kind == "swiglu" else 2
            enc_per += n_mats * d * self.d_ff + d
            total += self.n_enc_layers * enc_per
            # decoder cross-attention (one per decoder layer)
            total += L * (d * qd + 2 * d * kvd + qd * d + d)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_mats = 3 if self.ffn_kind == "swiglu" else 2
        ff = n_mats * self.d_model * self.d_ff
        inactive = self.n_layers * (self.moe.num_experts - self.moe.top_k) * ff
        return int(full - inactive)

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family (2L, d_model<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        hd = 32
        nh = max(2, min(self.n_heads, 4)) if self.attention != "none" else 0
        nkv = max(1, min(self.n_kv_heads, 2)) if self.attention != "none" else 0
        moe = None
        if self.moe is not None:
            moe = MoEConfig(num_experts=4, top_k=2, capacity_factor=self.moe.capacity_factor)
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(d_state=16, head_dim=32, expand=2, chunk=32, d_conv=4)
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            ssm=ssm,
            n_enc_layers=2 if self.enc_dec else 0,
            n_image_tokens=min(self.n_image_tokens, 16),
            n_audio_frames=min(self.n_audio_frames, 16),
            window=min(self.window, 64),
            dtype="float32",
        )


def pad_heads(cfg: "ArchConfig", multiple: int = 16) -> "ArchConfig":
    """TP head alignment: pad query heads up to ``multiple`` and kv heads to
    the smallest count that (a) divides the padded q count and (b) is >= the
    real kv count.  There is an exact weight embedding of the original model
    into the padded one (zero wq columns / wo rows for pad q-heads, with the
    real q heads laid out so slot//(Hq'/Hkv') == original kv group — see
    models/lm.embed_params_padded and tests/test_head_padding.py), so this is
    a layout change, not an approximation.  Cost: (Hq'-Hq)/Hq extra attention
    FLOPs; benefit: attention shards ``multiple``-way instead of replicating.
    """
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq == 0 or hq % multiple == 0:
        return cfg
    n0 = hq // hkv                       # original q-per-kv group size
    # smallest padded (hq', hkv') with hq' a multiple of `multiple`,
    # hkv' | hq', hkv' >= hkv, and group size hq'/hkv' >= n0 (so every real
    # q head fits in its original kv group under the uniform repeat mapping)
    hq_p = ((hq + multiple - 1) // multiple) * multiple
    while True:
        cands = [k for k in range(hkv, hq_p + 1)
                 if hq_p % k == 0 and hq_p // k >= n0]
        if cands:
            return dataclasses.replace(cfg, n_heads=hq_p, n_kv_heads=cands[0])
        hq_p += multiple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
