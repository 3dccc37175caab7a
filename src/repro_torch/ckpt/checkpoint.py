"""Checkpointing: atomic ``.npz`` save and restore with step metadata (the
port of ``repro.ckpt.checkpoint``).

The file is the reference's layout: a ``__meta__`` JSON entry (the step
and the caller's metadata) and one array per leaf, keyed by the leaf's
path with ``::`` between the parts — dict keys, list indices.  A tree is a
nested dict or list of tensors, or a
:class:`~repro_torch.models.layers.ParamTree` (a per-layer list where the
reference stacks ``[L, ...]``, so its paths read ``layers::0::attn::wq``).
bf16 leaves are written as their 16-bit patterns (``uint16``: numpy has no
bf16) and read back into the ``like`` tree's dtype.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import ParamTree

Tree = Any
_SEP = "::"


def _children(node) -> Optional[list]:
    """The (name, child) pairs of an inner node; None for a tensor."""
    if isinstance(node, torch.Tensor):
        return None
    if isinstance(node, ParamTree):
        return [*node._parameters.items(), *node._modules.items()]
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, nn.ModuleList)):
        return [(str(i), c) for i, c in enumerate(node)]
    raise TypeError(f"a checkpoint tree holds dicts, lists, ParamTrees "
                    f"and tensors, not {type(node).__name__}")


def _leaves(tree: Tree, prefix: str = ""):
    """(path, leaf) of every leaf, depth first."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}{_SEP}{name}" if prefix
                           else str(name))


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``like``'s device."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, tree: Tree, *, step: int = 0,
         metadata: Optional[dict] = None) -> None:
    """Write ``tree`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: a reader sees the old file or the new
    one, never a torn write."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    arrays = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    meta = {"step": step, **(metadata or {})}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)            # atomic
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _rebuild(like, z, prefix: str = ""):
    """Nested dicts (lists where ``like`` has a list) of tensors."""
    kids = _children(like)
    if kids is None:
        return _from_numpy(z[prefix], like)
    out = {name: _rebuild(child, z, f"{prefix}{_SEP}{name}" if prefix
                          else str(name)) for name, child in kids}
    if isinstance(like, (list, nn.ModuleList)):
        return list(out.values())
    return out


def restore(path: str, like: Tree) -> tuple[Tree, dict]:
    """The tree saved at ``path`` in the structure of ``like``, each leaf
    in the dtype and on the device of ``like``'s leaf (a ParamTree's
    parameters keep ``like``'s ``requires_grad``), and the metadata."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        tree = _rebuild(like, z)
    if isinstance(like, ParamTree):
        tree = ParamTree(tree)
        for (_, new), (_, old) in zip(_leaves(tree), _leaves(like)):
            new.requires_grad_(old.requires_grad)
    return tree, meta


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """The checkpoint ``<prefix><step>.npz`` of the largest step in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-4]))
    return os.path.join(directory, cands[-1])
