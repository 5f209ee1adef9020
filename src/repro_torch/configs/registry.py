"""Registry of assigned architectures (+ paper-scale federated models).

Every entry is selectable via ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.nemotron_4_340b import CONFIG as _nem340
from repro_torch.configs.nemotron_4_15b import CONFIG as _nem15
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.deepseek_coder_33b import CONFIG as _dsc
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba

REGISTRY: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _llava, _seamless, _olmoe, _nem340, _nem15,
        _smollm, _mamba2, _granite, _dsc, _hymba,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(REGISTRY)
