"""Checkpoints of the port: the reference's flat-npz format
(``repro.checkpoint``), read and written from torch tensors."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
