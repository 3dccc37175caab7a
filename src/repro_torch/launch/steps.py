"""Step builders + shape records of every (arch × shape) input (the port of
``repro.launch.steps``).

These are the functions the dry-run runs on meta tensors and the
launchers execute:

  * ``train_step``   — forward + backward + optimiser update  (train_4k)
  * ``prefill_step`` — prompt forward, builds the cache       (prefill_32k)
  * ``serve_step``   — ONE new token against a seq_len cache  (decode shapes)

``input_specs`` returns meta tensors (shape and dtype, no allocation) for
every model input.

How a step computes on a mesh (:func:`assemble`).  It is SPMD in the local
view: every rank runs the model on its own blocks of the tensors.

  * Parameters are stored as this rank's blocks of ``param_specs``
    (tensor parallelism on "model", FSDP on "data"), each of the spec's
    local shape.
  * Tensor parallelism (Megatron's): in every family each "model" rank
    computes with its part of each weight (:func:`leaf_split`): its query
    heads and their key/value heads (a key/value head shared by the query
    heads of several ranks is computed by each of them), its columns of
    the MLP's up and gate products and rows of its down product, its
    Mamba2 heads (their ``w_z``/``w_x``/``w_dt`` columns, conv channels,
    A, D, dt bias and gated-norm units, ``w_out`` rows), its xLSTM heads
    (the mLSTM's q/k/v and gate columns, the sLSTM's gates, biases and
    block-diagonal R; the mLSTM's ``w_up`` by its units of both halves
    ``[x_in | gate]``, or whole with ``xlstm_pin_inner``; each
    ``w_down`` by rows), whisper's attention heads and MLP units, and its
    vocabulary rows of the embedding and columns of the LM head.  The
    kernels (flash attention, ``ssm_scan``, ``slstm_scan``) run on those
    local heads.  A product whose contraction dim is split is summed over
    "model" (``layers.matmul``), the gated norm's statistics too, the
    embedding sums its rows, the loss is the vocabulary-parallel
    cross-entropy and served logits are gathered whole
    (``distributed.collectives``).
  * Sequence parallelism (Megatron-SP): where the config sets
    ``seq_parallel`` (the train step sets it for dense models when tp > 1
    divides S, as the reference does) the residual stream between layers,
    and each layer's saved input, holds this rank's S/tp rows; each layer
    all-gathers its normed rows before the column-parallel products and
    ends each row-parallel product (the MoE's expert sum included) in a
    reduce-scatter (``models.transformer.block_full``).
  * What :func:`leaf_split` leaves whole is computed whole on every
    "model" rank: MLA's latent and shared rope key (its heads split as
    GQA's do), the xLSTM's depthwise convolutions, and any head or unit
    count the "model" axis does not divide (gemma-2b's 8 query heads at
    16 ranks).  The MoE experts are split by expert (``models.moe``'s
    expert-parallel branch, one sum over "model").
    ``LoweredStep.tp_compute`` lists which matrices run split and which
    whole.
  * A layer reads its weights through a view (:class:`Gathered`) that
    all-gathers each block just before use over every axis its spec
    splits, but the "model" dim that already holds this rank's part; a
    part that the spec leaves whole (a shared key/value head) is cut from
    the whole.  So a weight is gathered only while its layer runs.  Under
    ``torch.utils.checkpoint`` the gather runs again in the backward, and
    the gather's backward, a reduce-scatter, returns each gradient to its
    block: FSDP's pattern.
  * The batch's rows are split over dp where ``batch_specs`` splits them.
  * The loss is scaled by 1/world before the backward.  After it, each
    gradient is summed over the axes its spec replicates it on
    (``distributed.collectives`` says why no other collective is needed).
    So the update is the single-device one; only the order of the sums
    changes.
  * The decode cache is held as this rank's blocks of ``cache_specs``.
    Where those split the heads over "model" as the layers do, a step
    computes on its block as it is.  Where they split the sequence (over
    "model", "data" or both), the step keeps the block, marked with its
    place (``collectives.SeqSplit``): the layers write the new token only
    into the block that holds its slot and take the distributed softmax
    over the axes that split it (``models.attention.cached_attention``,
    ``models.mla``).  Otherwise (heads the layers split but the spec
    leaves whole, the conv tail) it cuts its heads from the block, and
    after the step gathers them back and keeps its block.

On a mesh of one rank every collective is the identity and every weight
whole, so the step is ``train()``'s own, op for op.
"""
from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import axis_mapping, axis_sizes
from repro_torch.launch.mesh import axis_mapping_for
from repro_torch.models import build_model, param_count
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import dtype_of
from repro_torch.optim import AdamW
from repro_torch.train.loop import build_train_step

PyTree = Any

#: MoE expert weights: split over "model" by expert, which the
#: expert-parallel branch computes from its own block
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the shape and dtype of an input, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# Input specs
# --------------------------------------------------------------------------
def batch_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta tensors of the *batch* argument of the step function (tokens
    int64, the port's index type)."""
    b, s = shape.global_batch, shape.seq_len
    act, ids = dtype_of(cfg), torch.int64
    if shape.mode == "train":
        if cfg.family == "audio":
            return {"frames": sds((b, cfg.enc_seq, cfg.d_model), act),
                    "tokens": sds((b, s + 1), ids)}
        if cfg.family == "vlm":
            return {"embeds": sds((b, s, cfg.d_model), act),
                    "labels": sds((b, s), ids)}
        return {"tokens": sds((b, s + 1), ids)}
    if shape.mode == "prefill":
        if cfg.family == "audio":
            return {"frames": sds((b, cfg.enc_seq, cfg.d_model), act),
                    "tokens": sds((b, s), ids)}
        if cfg.family == "vlm":
            return {"embeds": sds((b, s, cfg.d_model), act)}
        return {"tokens": sds((b, s), ids)}
    # decode: ONE token; the cache is a separate argument
    return {"token": sds((b, 1), ids)}


def cache_input_specs(api, shape: InputShape) -> PyTree:
    """Meta tensors of the decode cache at seq_len occupancy (its ``pos``,
    an int, aside)."""
    return shd.tree_map_with_path(
        lambda _, sd: sds(*sd), api.cache_shapes(shape.global_batch,
                                                 shape.seq_len))


def input_specs(cfg: ModelConfig, shape: InputShape, api=None) -> dict:
    """All step inputs as meta tensors (params/opt built separately)."""
    specs = {"batch": batch_input_specs(cfg, shape)}
    if shape.mode == "decode":
        specs["cache"] = cache_input_specs(api or build_model(cfg), shape)
    return specs


def param_input_specs(api) -> PyTree:
    """Meta tensors of the parameters, in the config's dtype."""
    dt = dtype_of(api.cfg)
    return shd.tree_map_with_path(lambda _, s: sds(s, dt),
                                  api.param_shapes())


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------
def build_prefill_step(api, max_len: Optional[int] = None) -> Callable:
    def prefill_step(params, batch):
        ml = max_len
        if ml is None:
            key = ("tokens" if "tokens" in batch else
                   "embeds" if "embeds" in batch else "frames")
            ml = batch[key].shape[1]
        return api.prefill(params, batch, ml)
    return prefill_step


def build_serve_step(api) -> Callable:
    def serve_step(params, batch, cache):
        return api.decode_step(params, batch, cache)
    return serve_step


# --------------------------------------------------------------------------
# Blocks of a mesh
# --------------------------------------------------------------------------
def block(t: torch.Tensor, spec, mesh, keep=()) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (dims in ``keep`` as
    they are)."""
    for d, entry in enumerate(spec):
        axes = shd.entry_axes(entry)
        n = coll.group_size(mesh, axes) if axes else 1
        if n > 1 and d not in keep:
            size = t.shape[d] // n
            t = t.narrow(d, coll.group_rank(mesh, axes) * size, size)
    return t


def _own_block(t: torch.Tensor, spec, mesh, keep=()) -> torch.Tensor:
    """:func:`block` in storage of its own (a view would keep the whole
    alive)."""
    b = block(t, spec, mesh, keep)
    return b if b.shape == t.shape else b.clone()


def whole(t: torch.Tensor, spec, mesh, keep=()) -> torch.Tensor:
    """All-gather a block into the whole along every split dim but those
    in ``keep``."""
    for d, entry in enumerate(spec):
        axes = shd.entry_axes(entry)
        if axes and d not in keep:
            t = coll.all_gather(t, mesh, axes, d)
    return t


# --------------------------------------------------------------------------
# Tensor parallelism: which part of each weight a "model" rank computes with
# --------------------------------------------------------------------------
_ATTN_PARENTS = ("attn", "self_attn", "cross_attn")
_MLP_PARENTS = ("mlp", "shared")
_MAMBA_COLS = ("w_z", "w_x", "w_dt", "conv_x_w")
_MAMBA_UNITS = ("conv_x_b", "norm_scale", "a_log", "d_skip", "dt_bias")
#: xLSTM leaves split by head: the mLSTM's and the sLSTM's columns, and
#: their per-unit vectors (the sLSTM's block-diagonal R by its head dim)
_XLSTM_COLS = ("w_q", "w_k", "w_v", "w_ig", "w_fg", "w_z", "w_i", "w_f",
               "w_o")
_XLSTM_UNITS = ("b_ig", "b_fg", "out_norm_scale", "b_z", "b_i", "b_f",
                "b_o", "r_z", "r_i", "r_f", "r_o")


def _kv_split(cfg, tp: int, rank: int) -> Optional[coll.Split]:
    """The key/value heads of rank ``rank``'s query heads (None: the
    attention is computed whole on every "model" rank)."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if cfg.attn_kind == "mla" or hq % tp or (hkv % tp and tp % hkv):
        return None
    if hkv % tp == 0:
        return coll.Split(1, rank, tp)
    return coll.Split(1, rank // (tp // hkv), hkv)   # shared by tp/hkv ranks


def leaf_split(path, shape, cfg, tp: int, rank: int
               ) -> Optional[coll.Split]:
    """The part of one parameter leaf that "model" rank ``rank`` of ``tp``
    computes with (module docstring), or None: the whole."""
    if tp == 1:
        return None
    name = str(path[-1])
    parent = str(path[-2]) if len(path) > 1 else ""
    if name in ("embed", "lm_head"):
        if cfg.vocab_size % tp:
            return None
        return coll.Split(0 if name == "embed" else 1, rank, tp)
    if cfg.family == "ssm":
        return _xlstm_split(path, name, cfg, tp, rank)
    if parent == "attn" and cfg.attn_kind == "mla":
        if cfg.num_heads % tp:
            return None
        cols = coll.Split(1, rank, tp)
        return {"wq": cols, "w_uk": cols, "w_uv": cols,
                "wo": coll.Split(0, rank, tp)}.get(name)
    if parent in _ATTN_PARENTS:
        kv = _kv_split(cfg, tp, rank)
        if kv is None:
            return None
        return {"wq": coll.Split(1, rank, tp), "wo": coll.Split(0, rank, tp),
                "wk": kv, "wv": kv}.get(name)
    if parent in _MLP_PARENTS and len(shape) == 2 and name in (
            "w_gate", "w_up", "w_down"):
        dim = 0 if name == "w_down" else 1
        return coll.Split(dim, rank, tp) if shape[dim] % tp == 0 else None
    if cfg.family == "hybrid" and "mamba" in path \
            and cfg.n_ssm_heads % tp == 0:
        if name in _MAMBA_COLS:
            return coll.Split(1, rank, tp)
        if name in _MAMBA_UNITS or name == "w_out":
            return coll.Split(0, rank, tp)
    return None


def _xlstm_split(path, name, cfg, tp: int, rank: int
                 ) -> Optional[coll.Split]:
    """An xLSTM leaf's part: by head where the heads divide the "model"
    group (the mLSTM's q/k/v and gates, the sLSTM's gates, biases and
    R, both output norms); the mLSTM's ``w_up`` by this rank's units of
    each half, unless ``xlstm_pin_inner`` computes it whole; each
    ``w_down`` by rows where its units divide."""
    heads = cfg.num_heads % tp == 0
    units = (int(cfg.xlstm_proj_factor * cfg.d_model) if "mlstm" in path
             else cfg.d_model)
    if name == "w_up":
        if cfg.xlstm_pin_inner or units % tp:
            return None
        return coll.Split(1, rank, tp, groups=2)
    if name == "w_down":
        return coll.Split(0, rank, tp) if units % tp == 0 else None
    if heads and name in _XLSTM_COLS:
        return coll.Split(1, rank, tp)
    if heads and name in _XLSTM_UNITS:
        return coll.Split(0, rank, tp)
    return None


def tp_splits(cfg, pshapes, mesh) -> PyTree:
    """:func:`leaf_split` of every leaf, for this rank (rank 0 on an
    abstract mesh)."""
    tp = axis_sizes(mesh).get("model", 1)
    rank = mesh.get_local_rank("model") if tp > 1 else 0
    return shd.tree_map_with_path(
        lambda path, s: leaf_split(path, s, cfg, tp, rank), pshapes)


def tp_summary(pshapes, splits) -> dict:
    """The matrices computed on this rank's part and those computed whole
    on every "model" rank, by name (layer indices dropped)."""
    out = {"split": set(), "whole": set()}
    for path, split, shape in _pairs(splits, pshapes):
        if len(shape) >= 2:
            name = "/".join(str(p) for p in path if not isinstance(p, int))
            out["split" if split else "whole"].add(name)
    return {k: sorted(v) for k, v in out.items()}


def _model_keeps(t, spec, split, mesh) -> bool:
    """Whether the stored block along ``split.dim`` already is the part."""
    return (split is not None and spec[split.dim] == "model"
            and split.parts == axis_sizes(mesh)["model"]
            and split.groups == 1)


def local_weight(t: torch.Tensor, spec, mesh, split, keep=()
                 ) -> torch.Tensor:
    """The tensor a layer computes with from a stored block: gathered
    whole over every split dim, but for ``keep`` and, with ``split``, this
    rank's part (kept as stored, or cut from the whole), marked."""
    keep = tuple(keep)
    if _model_keeps(t, spec, split, mesh):
        keep += (split.dim,)
    w = whole(t, spec, mesh, keep)
    if split is None:
        return w
    if split.dim in keep:
        w = w.view(w.shape)                    # a tensor of its own to mark
    else:
        w = split.take(w)
    return coll.mark(w, split)


def _expert_keep(name, t, spec) -> tuple:
    """Dim 0 of an expert weight split over "model" stays a block."""
    if (name in _EXPERT_LEAVES and t.ndim == 3
            and "model" in shd.entry_axes(spec[0])):
        return (0,)
    return ()


class Gathered:
    """A read-only view of a tree of parameter blocks whose leaves read as
    :func:`local_weight` gives them, gathered at each read: the models
    index it as they index a ParamTree."""

    def __init__(self, node, spec, splits, mesh):
        self._node, self._spec, self._splits = node, spec, splits
        self._mesh = mesh

    def __getitem__(self, key):
        child, spec, split = (self._node[key], self._spec[key],
                              self._splits[key])
        if isinstance(child, torch.Tensor):
            return local_weight(child, spec, self._mesh, split,
                                _expert_keep(key, child, spec))
        return Gathered(child, spec, split, self._mesh)

    def __iter__(self):
        return (self[i] for i in range(len(self._node)))

    def __len__(self) -> int:
        return len(self._node)

    def __contains__(self, key) -> bool:
        return key in self._node


def _pairs(specs, node, path=()):
    """(path, spec, leaf) of a spec tree and a ParamTree / dict tree."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _pairs(v, node[k], path + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _pairs(v, node[i], path + (i,))
    else:
        yield path, specs, node


def _rebuild(specs, leaves: dict):
    """A nested dict/list shaped as ``specs`` from {path: tensor}."""
    return shd.tree_map_with_path(lambda path, _: leaves[path], specs)


@dataclasses.dataclass
class LoweredStep:
    """One (arch, shape, mesh) step, ready to run on this rank's blocks.

    ``jitted`` is the step to call (the port compiles nothing: it runs
    eagerly); ``arg_specs`` are meta tensors of its whole arguments —
    (params, AdamW moments, batch) in training, (params, batch) in
    prefill, (params, batch, cache) in decode; ``specs`` their partition
    specs in the same order (the moments take the params').
    ``tp_compute``: :func:`tp_summary` of the step's weights."""
    name: str
    jitted: Callable
    arg_specs: tuple
    shard_report: shd.ShardingReport
    cfg: ModelConfig = None
    api: Any = None
    mesh: Any = None
    mode: str = "train"
    specs: tuple = ()
    tp_compute: dict = dataclasses.field(default_factory=dict)

    def __call__(self, *args):
        return self.jitted(*args)

    def shard_params(self, params) -> ParamTree:
        """This rank's blocks of whole ``params`` (a ParamTree), as a new
        ParamTree with the same ``requires_grad`` (a block that is the
        whole tensor shares its storage)."""
        trainable = any(p.requires_grad for p in params.parameters())
        leaves = {path: _own_block(t.detach(), s, self.mesh)
                  for path, s, t in _pairs(self.specs[0], params)}
        return ParamTree(_rebuild(self.specs[0], leaves)).requires_grad_(
            trainable)

    @torch.no_grad()
    def gather_params(self, params) -> ParamTree:
        """The whole parameters from this rank's blocks (every rank)."""
        leaves = {path: whole(t.detach(), s, self.mesh)
                  for path, s, t in _pairs(self.specs[0], params)}
        return ParamTree(_rebuild(self.specs[0], leaves))


def _sync_grads(params, pspecs, mesh) -> None:
    """Sum each gradient over the mesh axes its spec replicates it on."""
    names = tuple(mesh.mesh_dim_names)
    for _, spec, p in _pairs(pspecs, params):
        if p.grad is None:
            continue
        used = {a for e in spec for a in shd.entry_axes(e)}
        rep = tuple(a for a in names if a not in used)
        if rep:
            coll.all_reduce_(p.grad, mesh, rep)


def _mesh_train_step(api, opt, mesh, pspecs, splits, bspecs, mapping,
                     split):
    world = mesh.size()

    def train_step(params, opt_state, batch):
        opt_state = opt_state or opt(params.parameters())
        local = {k: block(t, bspecs[k], mesh) for k, t in batch.items()}
        with axis_mapping(mapping, mesh=mesh, batch_split=split):
            loss, metrics = api.train_loss(
                Gathered(params, pspecs, splits, mesh), local)
            opt_state.zero_grad(set_to_none=True)
            (loss / world if world > 1 else loss).backward()
            _sync_grads(params, pspecs, mesh)
        opt_state.step()
        loss = loss.detach()
        if world > 1:                    # the mean over the whole batch
            loss = coll.all_reduce(loss, mesh, tuple(mesh.mesh_dim_names)
                                   ) / world
        return params, opt_state, loss, metrics
    return train_step


# --------------------------------------------------------------------------
# The decode cache: stored blocks <-> the layout the layers compute with
# --------------------------------------------------------------------------
_MLSTM_STATE = ("m_C", "m_n", "m_m")
_SLSTM_STATE = ("s_c", "s_n", "s_h", "s_m")


def _seq_dim(name: str, spec) -> Optional[int]:
    """The sequence dim of a key/value or latent cache leaf whose spec
    splits it (None: not such a leaf, or its sequence whole)."""
    if name not in shd._KV_LEAVES and name not in shd._LATENT_LEAVES:
        return None
    return 2 if shd.entry_axes(spec[2]) else None     # [L, B, S, ...]


def cache_splits(cfg, cspecs, mesh, *, decode: bool = False) -> PyTree:
    """Per cache leaf, the part of its heads this rank computes with: the
    key/value heads of its query heads ([..., S, Hkv, D], dim -2), the
    SSM heads ([L, B, H, P, N], dim 2), the mLSTM's heads ([G, M, B, H,
    ...], dim 3) or the sLSTM's units ([G, B, d], dim 2), or for the conv
    tail ([L, B, W-1, d_inner + 2N]) its own d_inner columns (a Split on
    dim -1 whose ``parts`` split only those); None: whole.  In ``decode``
    a key/value leaf whose sequence is split over "model" is None: its
    block serves every head (``attention.cached_attention``)."""
    tp = axis_sizes(mesh).get("model", 1)
    rank = mesh.get_local_rank("model") if tp > 1 else 0
    kv = leaf_split(("attn", "wk"), (), cfg, tp, rank)
    mamba = leaf_split(("mamba", 0, "w_x"), (), cfg, tp, rank)
    mlstm = leaf_split(("mlstm", 0, "w_q"), (), cfg, tp, rank)
    slstm = leaf_split(("slstm", 0, "w_z"), (), cfg, tp, rank)

    def split(path, spec):
        name = str(path[-1])
        if name in shd._KV_LEAVES and kv is not None:
            seq = _seq_dim(name, spec)
            if decode and seq is not None \
                    and "model" in shd.entry_axes(spec[seq]):
                return None
            return coll.Split(len(spec) - 2, kv.index, kv.parts)
        if name == "ssm" and mamba is not None:
            return coll.Split(2, rank, tp)
        if name == "conv" and mamba is not None:
            return coll.Split(len(spec) - 1, rank, tp)
        if name in _MLSTM_STATE and mlstm is not None:
            return coll.Split(3, rank, tp)
        if name in _SLSTM_STATE and slstm is not None:
            return coll.Split(2, rank, tp)
        return None
    return shd.tree_map_with_path(split, cspecs)


def _seq_mark(name, t, spec, mesh) -> torch.Tensor:
    """Mark a decode cache block whose spec splits its sequence with its
    ``SeqSplit`` (the layers' distributed softmax reads it)."""
    seq = _seq_dim(name, spec)
    if seq is None:
        return t
    axes = shd.entry_axes(spec[seq])
    return coll.mark_seq(t, coll.SeqSplit(axes, coll.group_rank(mesh, axes),
                                          coll.group_size(mesh, axes)))


def _cache_in(name, t, spec, split, keep, *, mesh, d_inner):
    """A stored cache block → the tensor the layers compute with.  A
    block whose sequence is split stays this rank's block (``keep`` holds
    its sequence dim), marked."""
    if _model_keeps(t, spec, split, mesh):
        w = whole(t, spec, mesh, keep + (split.dim,))
    else:
        w = whole(t, spec, mesh, keep)
        if split is not None and name == "conv":            # conv tail
            cols = d_inner // split.parts
            return torch.cat([w[..., split.index * cols:
                                (split.index + 1) * cols],
                              w[..., d_inner:]], dim=-1)
        if split is not None:
            w = split.take(w).contiguous()
    return _seq_mark(name, w, spec, mesh)


def _cache_out(name, t, spec, split, keep, *, mesh, d_inner):
    """The tensor the layers computed with → this rank's stored block."""
    if _model_keeps(t, spec, split, mesh):
        return _own_block(t, spec, mesh, keep + (split.dim,))
    if split is not None:
        tp, axes = axis_sizes(mesh)["model"], ("model",)
        if name == "conv":                                   # conv tail
            cols = d_inner // split.parts
            t = torch.cat([coll.all_gather(t[..., :cols], mesh, axes, -1),
                           t[..., cols:]], dim=-1)
        else:
            t = coll.all_gather(t, mesh, axes, split.dim)
            if split.parts < tp:       # ranks that shared a head: one copy
                d = split.dim % t.ndim
                t = t.unflatten(d, (split.parts, tp // split.parts, -1)
                                ).select(d + 1, 0).flatten(d, d + 1)
    return _own_block(t, spec, mesh, keep)


def _batch_dims(cspecs, dp, *, seq: bool = False) -> dict:
    """Per cache leaf: the dim its spec splits over exactly the dp axes
    (its batch rows), kept a block when the batch is split; with ``seq``
    also a key/value or latent leaf's split sequence dim (a decode step
    keeps its block)."""
    def dims(path, spec):
        out = tuple(d for d, e in enumerate(spec)
                    if dp and shd.entry_axes(e) == dp)
        sd = _seq_dim(str(path[-1]), spec) if seq else None
        return out if sd is None else tuple(sorted(set(out) | {sd}))
    return shd.tree_map_with_path(dims, cspecs)


def _map_cache(fn, cache: dict, cspecs, splits, keep) -> dict:
    """``fn(name, tensor, spec, split, keep)`` over a cache's tensors;
    ``pos`` as is."""
    out = {}
    for k, v in cache.items():
        if k not in cspecs:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _map_cache(fn, v, cspecs[k], splits[k], keep[k])
        else:
            out[k] = fn(k, v, cspecs[k], splits[k], keep[k])
    return out


def assemble(cfg: ModelConfig, shape: InputShape, mesh, *,
             opt=None, seq_shard_cache: bool = False,
             extra_cfg_kw: Optional[dict] = None,
             auto_knobs: bool = True) -> LoweredStep:
    """Build one (arch, shape) step on ``mesh`` (module docstring).

    ``opt`` makes the optimiser from the parameters; default the
    reference's ``adamw(1e-4)``: the port's AdamW (b2 0.95, weight decay
    0.1) at a constant rate."""
    if extra_cfg_kw:
        cfg = cfg.replace(**extra_cfg_kw)
        auto_knobs = False            # explicit knobs win (perf experiments)
    mode = "train" if shape.mode == "train" else "serve"
    axis = axis_sizes(mesh)
    tp = axis.get("model", 1)
    if shape.mode == "train":
        kw = {}
        # SP's residual all-gathers around the MoE cost more than they
        # save in the reference: SP is dense-only
        if auto_knobs and tp > 1 and shape.seq_len % tp == 0 \
                and not cfg.seq_parallel and not cfg.num_experts:
            kw["seq_parallel"] = True        # Megatron-SP residual stream
        if auto_knobs and not cfg.loss_chunk and cfg.vocab_size >= 32000:
            kw["loss_chunk"] = 512           # chunked cross-entropy
        if kw:
            cfg = cfg.replace(**kw)
    api = build_model(cfg)
    pshapes = api.param_shapes()
    # FSDP all-gathers cost more than they save for small models in the
    # reference: replicate params below 0.5B
    no_fsdp = (mode == "train" and param_count(pshapes) < 5e8
               and not os.environ.get("REPRO_FORCE_FSDP"))
    pspecs, report = shd.param_specs(cfg, pshapes, mesh, mode=mode,
                                     no_fsdp=no_fsdp)
    splits = tp_splits(cfg, pshapes, mesh)
    params_sds = param_input_specs(api)
    batch_sds = batch_input_specs(cfg, shape)
    bspecs = shd.batch_specs(cfg, batch_sds, mesh)
    mapping = axis_mapping_for(mesh)
    dp = tuple(mapping["dp"])
    split = any(s and s[0] is not None for s in bspecs.values())
    base = dict(cfg=cfg, api=api, mesh=mesh, mode=shape.mode,
                tp_compute=tp_summary(pshapes, splits))

    def weights(params):
        return Gathered(params, pspecs, splits, mesh)

    if shape.mode == "train":
        opt = opt or partial(AdamW, lr=1e-4)
        moments = shd.tree_map_with_path(
            lambda _, t: sds(t.shape, torch.float32), params_sds)
        return LoweredStep(
            f"{cfg.name}/{shape.name}/train",
            _mesh_train_step(api, opt, mesh, pspecs, splits, bspecs,
                             mapping, split),
            (params_sds, {"m": moments, "v": moments}, batch_sds), report,
            specs=(pspecs, bspecs, {"m": pspecs, "v": pspecs}), **base)

    cache_sds = cache_input_specs(api, shape)
    cspecs = shd.cache_specs(cfg, cache_sds, mesh,
                             seq_shard=seq_shard_cache
                             and shape.mode == "decode")
    csplits = cache_splits(cfg, cspecs, mesh)
    keep = _batch_dims(cspecs, dp)
    conv = dict(mesh=mesh, d_inner=cfg.d_inner)
    cache_in = partial(_cache_in, **conv)
    cache_out = partial(_cache_out, **conv)

    if shape.mode == "prefill":
        step = build_prefill_step(api, max_len=shape.seq_len)

        def prefill_step(params, batch):
            local = {k: block(t, bspecs[k], mesh) for k, t in batch.items()}
            with axis_mapping(mapping, mesh=mesh, batch_split=split):
                logits, cache = step(weights(params), local)
            return logits, _map_cache(cache_out, cache, cspecs, csplits,
                                      keep)
        return LoweredStep(f"{cfg.name}/{shape.name}/prefill", prefill_step,
                           (params_sds, batch_sds), report,
                           specs=(pspecs, bspecs, cspecs), **base)

    step = build_serve_step(api)
    dsplits = cache_splits(cfg, cspecs, mesh, decode=True)
    dkeep = _batch_dims(cspecs, dp, seq=True)

    def serve_step(params, batch, cache):
        local = {k: block(t, bspecs[k], mesh) for k, t in batch.items()}
        held = _map_cache(cache_in, cache, cspecs, dsplits, dkeep)
        with axis_mapping(mapping, mesh=mesh, batch_split=split):
            logits, held = step(weights(params), local, held)
        return logits, _map_cache(cache_out, held, cspecs, dsplits, dkeep)
    return LoweredStep(f"{cfg.name}/{shape.name}/decode", serve_step,
                       (params_sds, batch_sds, cache_sds), report,
                       specs=(pspecs, bspecs, cspecs), **base)


def static_bytes(step: LoweredStep) -> dict:
    """Bytes one rank holds across the step, exactly from the specs' local
    shapes: parameters (and in training their gradients and AdamW's two
    f32 moments), the batch, and the decode cache."""
    mesh = step.mesh

    def local_bytes(tree, specs) -> int:
        pairs = []
        shd.tree_map_with_path(lambda path, t: pairs.append((path, t)), tree)
        total = 0
        for path, t in pairs:
            s = specs
            for k in path:
                s = s[k]
            total += math.prod(shd.local_shape(tuple(t.shape), s, mesh)) \
                * t.element_size()
        return total

    out = {"params": local_bytes(step.arg_specs[0], step.specs[0]),
           "batch": local_bytes(step.arg_specs[1 if step.mode != "train"
                                               else 2], step.specs[1])}
    if step.mode == "train":
        out["grads"] = out["params"]
        out["opt_moments"] = local_bytes(step.arg_specs[1], step.specs[2])
    if step.mode == "decode":
        out["cache"] = local_bytes(step.arg_specs[2], step.specs[2])
    out["total"] = sum(out.values())
    return out


def arch_shape_cfg(cfg: ModelConfig, shape: InputShape
                   ) -> Optional[ModelConfig]:
    """Shape-dependent config adaptation + skip policy: returns the adapted
    config, or None if the pair is skipped."""
    if shape.name.startswith("long_500k"):
        if cfg.family == "audio":
            return None               # no 500k-token decoder for whisper
        if cfg.family in ("dense", "vlm"):
            # sliding-window variant bounds cache memory at 512k context
            return cfg.with_window(8192)
    return cfg

