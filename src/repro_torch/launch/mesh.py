"""Mesh construction (the port of ``repro.launch.mesh``).

The production meshes are abstract (names and sizes, no devices): the
dry-run plans for them on one host.  A device mesh needs an initialised
process group, which :func:`start_group` makes from a ``FileStore``, so
that no network address is needed:

  * :func:`make_debug_mesh` — the reference's forced host devices as
    ``gloo`` ranks on the CPU, a ``(devices//2, 2)`` mesh;
  * :func:`make_card_mesh` — one card, an ``nccl`` group of world size 1,
    a ``(1, 1)`` mesh;
  * :func:`make_shared_card_mesh` — ``gloo`` ranks that share one card, a
    ``(devices//2, 2)`` mesh (``launch.card_mesh``).

Every group gets a timeout, so a stuck collective fails instead of
hanging.  If ``nccl`` cannot start, that is an error: there is no
fallback to ``gloo``.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.context import AbstractMesh

#: the timeout of every process group this module starts
GROUP_TIMEOUT_S = 120


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16×16 = 256 chips (data, model).
    Multi-pod: 2×16×16 = 512 chips (pod, data, model)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def start_group(backend: str, rank: int, world_size: int, store_path: str,
                timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Initialise the default process group over a ``FileStore`` at
    ``store_path`` (a file every rank can reach; it must not exist yet)."""
    store = dist.FileStore(store_path, world_size)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_debug_mesh(devices: int = 4):
    """Tiny ``(devices//2, 2)`` ("data", "model") mesh over the
    initialised ``gloo`` group of ``devices`` CPU ranks."""
    if not dist.is_initialized() or dist.get_world_size() != devices:
        raise RuntimeError(f"make_debug_mesh({devices}) needs an initialised "
                           f"process group of {devices} ranks "
                           "(launch.mesh.start_group)")
    return init_device_mesh("cpu", (devices // 2, 2),
                            mesh_dim_names=("data", "model"))


def make_shared_card_mesh(devices: int = 4):
    """A ``(devices//2, 2)`` ("data", "model") mesh over the initialised
    ``gloo`` group of ``devices`` ranks that all compute on ``cuda:0``
    (``nccl`` puts no two ranks on one device): each rank's compute on
    the card, its collectives through gloo (``launch.card_mesh``)."""
    if not dist.is_initialized() or dist.get_world_size() != devices:
        raise RuntimeError(f"make_shared_card_mesh({devices}) needs an "
                           f"initialised process group of {devices} ranks "
                           "(launch.mesh.start_group)")
    torch.cuda.set_device(0)
    return init_device_mesh("cuda", (devices // 2, 2),
                            mesh_dim_names=("data", "model"))


def make_card_mesh(store_path: str):
    """The one-card ``(1, 1)`` ("data", "model") mesh: an ``nccl`` group of
    world size 1 on ``cuda:0``."""
    start_group("nccl", 0, 1, store_path)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def axis_mapping_for(mesh) -> dict:
    """Logical→mesh axis mapping used by sharding constraints."""
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return {"dp": dp, "tp": ("model",) if "model" in names else (),
            "sp": ("data",) if "data" in names else ()}
