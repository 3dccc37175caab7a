"""Checkpoints: atomic ``.npz`` save/restore (the port of ``repro.ckpt``)."""
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import latest, restore, save

__all__ = ["checkpoint", "latest", "restore", "save"]
