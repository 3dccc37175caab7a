"""Mesh-agnostic sharding-constraint hooks (the port of
``repro.distributed.context``).

Model code calls ``constrain(x, "activation")`` at the reference's places
(embeddings out, the residual stream between layers, logits, the MoE
input).  Outside a mesh this is the identity.  A step builder of
``repro_torch.launch.steps`` activates a mesh with :func:`axis_mapping`
while its step runs; the MoE layer reads the mesh from here to take its
expert-parallel branch.  A model whose config sets ``seq_parallel``
splits its residual stream by sequence over the "model" group
(:func:`sp_split`, :func:`sequence_parallel`), and
``constrain(x, "activation_sp")`` checks that split.

Logical axes:
  dp  — batch/data parallel        → ("pod", "data") or ("data",)
  tp  — tensor/model parallel      → ("model",)
  sp  — sequence parallel (opt-in) → ("data",)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialised process group, or an :class:`AbstractMesh` (axis names and
sizes, no devices) on which specs are computed and the dry-run runs a
rank's step with shape-only collectives.  Both answer ``mesh_dim_names``,
``shape``, ``size()`` and ``get_local_rank(name)``.
"""
from __future__ import annotations

import collections
import contextlib
import math
import types
from typing import Optional

import torch

# the active step's mapping, mesh and splits: process-wide, not
# thread-local, since the autograd engine runs a CUDA backward (and with it
# the recomputation of each checkpointed layer, whose collectives read the
# mesh) on a thread of its own
_state = types.SimpleNamespace()

# logical name -> PartitionSpec template (in logical axes)
SPEC_TABLE = {
    # [B, S, d]
    "activation": ("dp", None, None),
    # [B, S, d] with Megatron-style sequence parallelism
    "activation_sp": ("dp", "tp", None),
    # [B, S, V]
    "logits": ("dp", None, "tp"),
    # [E, C, d]
    "moe_buffer": ("tp", None, None),
    # [B, S, H, D]
    "heads": ("dp", None, "tp", None),
    # KV cache [B, S, Hkv, D]
    "kv_cache": ("dp", None, None, None),
    # KV cache, sequence-parallel variant
    "kv_cache_sp": ("dp", "sp", None, None),
}

#: calls of :func:`constrain` made while a mesh was active, per spec name
CONSTRAINED: collections.Counter = collections.Counter()


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (whole), a mesh axis name, or a
    tuple of axis names split jointly (the first the slowest), as jax's
    ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh of named axes with sizes and no devices: specs are computed
    on it, and the dry-run runs rank 0's step on it."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axis_names)

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return (f"AbstractMesh({dict(zip(self.mesh_dim_names, self.shape))})")


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mapping() -> Optional[dict]:
    return getattr(_state, "mapping", None)


@contextlib.contextmanager
def sequence_parallel(seq: Optional[int]):
    """While active with ``seq`` (not None), the residual stream of
    ``seq`` rows is split by sequence over the "model" group: each rank
    holds its ``seq // tp`` rows (``distributed.collectives.tp_stream``,
    ``tp_reduce``, ``tp_rows`` read this)."""
    prev = getattr(_state, "sp_seq", None)
    _state.sp_seq = seq
    try:
        yield
    finally:
        _state.sp_seq = prev


def sp_seq() -> Optional[int]:
    """The whole length of the active sequence-parallel stream (None: no
    split active)."""
    return getattr(_state, "sp_seq", None)


def tp_size() -> int:
    """The size of the active step's "model" group (1 outside a
    mesh)."""
    mesh, axes = current_mesh(), tp_axes()
    if mesh is None or not axes:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def sp_split(cfg, seq: int) -> Optional[int]:
    """``seq`` where ``cfg.seq_parallel`` splits a stream of ``seq`` rows
    on the active mesh ("model" > 1 and dividing ``seq``), else None: a
    sequence the group does not divide keeps the whole stream."""
    tp = tp_size()
    return seq if cfg.seq_parallel and tp > 1 and seq % tp == 0 else None


@contextlib.contextmanager
def axis_mapping(mapping: dict[str, tuple[str, ...]], mesh=None, *,
                 batch_split: bool = False):
    """mapping: logical axis -> tuple of mesh axis names (or ()).
    ``batch_split``: the step's activations hold only this rank's batch
    rows (its batch was split over the dp axes); otherwise every rank holds
    every row."""
    prev = (_mapping(), getattr(_state, "mesh", None),
            getattr(_state, "batch_split", False))
    _state.mapping, _state.mesh, _state.batch_split = (mapping, mesh,
                                                      batch_split)
    try:
        yield
    finally:
        _state.mapping, _state.mesh, _state.batch_split = prev


def current_mesh():
    """The mesh of the active step builder (None outside one)."""
    return getattr(_state, "mesh", None)


def batch_split() -> bool:
    """Whether the active step's activations hold only this rank's rows."""
    return bool(getattr(_state, "batch_split", False))


def dp_axes() -> tuple[str, ...]:
    m = _mapping()
    return tuple(m.get("dp", ())) if m else ()


def tp_axes() -> tuple[str, ...]:
    m = _mapping()
    return tuple(m.get("tp", ())) if m else ()


def resolve(name: str) -> Optional[PartitionSpec]:
    m = _mapping()
    if m is None:
        return None
    axes = []
    for a in SPEC_TABLE[name]:
        mesh_axes = m.get(a, ()) if a is not None else ()
        axes.append(tuple(mesh_axes) if mesh_axes else None)
    return P(*axes)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Pin ``x`` to the layout ``SPEC_TABLE[name]`` names.

    Outside a mesh: the identity.  Inside one, this is the port's
    counterpart of ``jax.lax.with_sharding_constraint``.  GSPMD sees the
    global tensor and moves data until it has the spec's layout; a port
    step sees each rank's local block, and every tensor at these places
    already has the one layout the step gives it (``launch/steps.py``):
    its batch rows split over dp when the batch was split, the residual
    stream split by sequence over "model" inside a
    :func:`sequence_parallel` block (``activation_sp``) and whole
    elsewhere, the logits split over "model" by vocabulary where the LM
    head is.  So nothing moves: the spec is resolved, a rank mismatch is
    skipped (as the reference skips its ``ValueError``), an
    ``activation_sp`` stream that does not hold this rank's
    ``seq // tp`` rows of an active split raises, and the call is counted
    in :data:`CONSTRAINED`."""
    spec = resolve(name)
    if spec is None or x.ndim != len(spec):
        return x
    seq = sp_seq()
    if name == "activation_sp" and seq is not None \
            and x.shape[1] * tp_size() != seq:
        raise ValueError(f"activation_sp: {x.shape[1]} rows a rank, not "
                         f"{seq} // {tp_size()} of the sequence-parallel "
                         "stream")
    CONSTRAINED[name] += 1
    return x
