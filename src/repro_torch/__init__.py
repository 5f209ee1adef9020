"""PyTorch/CUDA port of the FedGS reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and holds each piece against it.  It imports ``torch`` and numpy only.
The FedGS hot path runs through hand-written CUDA kernels for Hopper
(``repro_torch.kernels``); each kernel sits beside a plain PyTorch version
that serves CPU tensors.
"""

import torch


def resolve_device(device=None, *, who: str = "repro_torch") -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, and raises when the
    machine has none (the port never falls back to the CPU silently)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on CUDA by default and this machine "
                           "has no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")
