"""A copy of ``repro.configs`` (framework-free data: the architecture and
input-shape configurations).  The port keeps its own copy so that it imports
nothing of the JAX package; ``tests/test_torch_lm.py`` holds every config,
and its ``reduced()`` variant, equal to the original field by field."""
from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES
from repro_torch.configs.registry import get_config, list_archs, REGISTRY
