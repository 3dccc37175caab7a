"""Parameter, batch and cache partitioning rules (the port of
``repro.distributed.sharding``), on a ``DeviceMesh`` or an
:class:`~repro_torch.distributed.context.AbstractMesh`.

Name-and-divisibility-driven :class:`PartitionSpec` assignment, the
reference's rules:

  * tensor parallelism ("model" axis): head-aligned projection dims, FFN
    hidden dims, expert axis, vocab — sharded iff the semantic unit count
    (heads / experts / vocab / d_ff) divides the axis size;
  * FSDP ("data", or ("pod","data") past 16, training only): the largest
    not-yet-sharded dim of every ≥2D weight, iff divisible;
  * everything that fails divisibility falls back to replication and is
    recorded in the returned :class:`ShardingReport`;
  * the levers ``REPRO_ROWPAR_ATTN`` (row-parallel attention projections
    where the heads do not divide the model axis) and ``REPRO_NO_FSDP``.

The port's parameters are per layer (``params["layers"][l]``) where the
reference stacks them, so a leaf's spec is the reference's with its
leading stack dims dropped: one entry per dimension of the port's leaf.
Its report names each layer's leaf (``layers/3/attn/wq``).  The decode
cache is stacked over layers in both packages, so :func:`cache_specs` is
the reference's, but for the hybrid's SSM state and conv tail: the port
stacks them [L, B, ...] where the reference has [G, K, B, ...], so their
spec is the reference's with its first stack dim dropped.  A spec tree
mirrors its shape tree: dicts and lists of shape tuples (or meta
tensors).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

from repro_torch.distributed.context import P, PartitionSpec, axis_sizes

PyTree = Any

# weights whose FIRST dim is the "input feature" dim (row-parallel)
_ROW_PARALLEL = ("wo", "w_down", "w_out")


@dataclasses.dataclass
class ShardingReport:
    """What got sharded how — and what fell back to replication."""
    tp_sharded: list[str] = dataclasses.field(default_factory=list)
    fsdp_sharded: list[str] = dataclasses.field(default_factory=list)
    replicated: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (f"tp={len(self.tp_sharded)} fsdp={len(self.fsdp_sharded)} "
                f"replicated={len(self.replicated)}")


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nest of dicts and lists; ``path`` holds
    dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def partition_spec_for(path, shape: tuple[int, ...], cfg, *,
                       tp: int, fsdp: int, mode: str,
                       report: Optional[ShardingReport] = None
                       ) -> PartitionSpec:
    """PartitionSpec for one per-layer param leaf. mode: 'train' |
    'serve'."""
    name = str(path[-1])
    body = list(shape)
    spec: list = [None] * len(shape)
    pstr = "/".join(str(p) for p in path)

    def try_tp(dim_idx: int, unit: int) -> bool:
        """Shard dim `dim_idx` on 'model' iff `unit` divides tp."""
        if tp > 1 and unit % tp == 0 and body[dim_idx] % tp == 0:
            spec[dim_idx] = "model"
            if report:
                report.tp_sharded.append(pstr)
            return True
        return False

    tp_ok = False
    if name == "embed":
        tp_ok = try_tp(0, shape[-2])                 # vocab rows
    elif name == "lm_head":
        tp_ok = try_tp(1, body[1])                   # vocab cols
    elif name in ("w_gate", "w_up", "w_down") and len(body) == 3:
        # MoE expert weights [E, d, ff]: expert parallelism
        if tp > 1 and cfg.num_experts and cfg.num_experts % tp == 0:
            spec[0] = "model"
            tp_ok = True
            if report:
                report.tp_sharded.append(pstr)
    elif name in ("wq", "w_q"):
        tp_ok = try_tp(1, cfg.num_heads)
    elif name in ("wk", "wv", "w_k", "w_v"):
        tp_ok = try_tp(1, cfg.num_kv_heads)
    elif name in ("w_uk", "w_uv"):                   # MLA up-proj [r, H*dn]
        tp_ok = try_tp(1, cfg.num_heads)
    elif name in ("w_z", "w_x", "conv_x_w", "w_ig", "w_fg"):
        # mamba/xlstm inner width: head-aligned
        unit = cfg.n_ssm_heads if cfg.family in ("hybrid",) else cfg.num_heads
        tp_ok = try_tp(len(body) - 1, unit)
    elif name in ("w_gate", "w_up"):                 # dense FFN [d, ff]
        tp_ok = try_tp(1, body[1])
    elif name in _ROW_PARALLEL and len(body) >= 2:
        if name == "w_down" and len(body) == 2:
            tp_ok = try_tp(0, body[0])
        elif name == "wo":
            tp_ok = try_tp(0, cfg.num_heads)
        elif name == "w_out":
            unit = cfg.n_ssm_heads if cfg.family in ("hybrid",) \
                else cfg.num_heads
            tp_ok = try_tp(0, unit)

    # row-parallel fallback for attention projections whose head count
    # does not divide the model axis: shard the contraction dim instead
    if (os.environ.get("REPRO_ROWPAR_ATTN") and not tp_ok and tp > 1
            and name in ("wq", "wk", "wv", "wo") and len(body) == 2
            and body[0] % tp == 0):
        spec[0] = "model"
        tp_ok = True
        if report:
            report.tp_sharded.append(pstr + "(rowpar)")

    # FSDP (training only): largest remaining dim of ≥2D weights
    if os.environ.get("REPRO_NO_FSDP"):
        fsdp = 1
    if mode == "train" and fsdp > 1 and len(body) >= 2:
        order = sorted(range(len(body)), key=lambda i: -body[i])
        for i in order:
            if spec[i] is None and body[i] % fsdp == 0:
                spec[i] = ("pod", "data") if fsdp > 16 else "data"
                if report:
                    report.fsdp_sharded.append(pstr)
                break

    if report and not tp_ok and all(s is None for s in spec):
        report.replicated.append(pstr)
    return P(*spec)


def param_specs(cfg, shapes: PyTree, mesh, mode: str = "train",
                no_fsdp: bool = False):
    """PartitionSpec tree for a param-shapes tree. Returns (specs,
    report)."""
    axis = axis_sizes(mesh)
    tp = axis.get("model", 1)
    fsdp = 1 if no_fsdp else axis.get("data", 1) * axis.get("pod", 1)
    report = ShardingReport()
    specs = tree_map_with_path(
        lambda path, leaf: partition_spec_for(
            path, _shape(leaf), cfg, tp=tp, fsdp=fsdp, mode=mode,
            report=report), shapes)
    return specs, report


def batch_specs(cfg, batch_shapes: PyTree, mesh):
    """Shard the batch dim over ('pod','data') where divisible."""
    axis = axis_sizes(mesh)
    dp = axis.get("data", 1) * axis.get("pod", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis and axis[a] > 1)

    def spec(_, leaf):
        shape = _shape(leaf)
        if shape and shape[0] % dp == 0 and dp > 1:
            return P(dp_axes, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec, batch_shapes)


_KV_LEAVES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
              "attn_k", "attn_v")
_LATENT_LEAVES = ("ckv", "kr")


def cache_specs(cfg, cache_shapes: PyTree, mesh, *,
                seq_shard: bool = False):
    """Decode-cache sharding (stacked over layers, as the reference's):

      * batch dim over dp where divisible;
      * KV heads over 'model' where divisible, else the *sequence* dim over
        'model';
      * MLA latent caches shard sequence over 'model' (no head dim);
      * when the batch cannot shard (long_500k B=1), the sequence
        additionally shards over 'data'.
    ``seq_shard=True`` forces sequence-over-'data' even when the batch is
    shardable.  Leaves are ``(shape, dtype)`` pairs, shape tuples or
    tensors."""
    axis = axis_sizes(mesh)
    dp = axis.get("data", 1) * axis.get("pod", 1)
    tp = axis.get("model", 1)
    data = axis.get("data", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis and axis[a] > 1)

    def spec(path, sd):
        shape = (tuple(sd[0]) if isinstance(sd, tuple) and sd
                 and isinstance(sd[0], tuple) else _shape(sd))
        name = str(path[-1])
        if name == "pos" or not shape:
            return P()
        s: list = [None] * len(shape)
        # leading layer-stack dims before the batch dim
        if name in _KV_LEAVES or name in _LATENT_LEAVES:
            nstack = 1
        elif name.startswith("m_"):
            nstack = 2
        elif name in ("ssm", "conv") or name.startswith("s_"):
            nstack = 1
        else:
            nstack = 0
        batch_ok = (nstack < len(shape) and dp > 1
                    and shape[nstack] % dp == 0)
        if batch_ok:
            s[nstack] = dp_axes
        if name in _KV_LEAVES and len(shape) >= 4:
            seq_dim, head_dim_idx = nstack + 1, len(shape) - 2
            if tp > 1 and shape[head_dim_idx] % tp == 0:
                s[head_dim_idx] = "model"
            elif tp > 1 and shape[seq_dim] % tp == 0:
                s[seq_dim] = "model"
            if (seq_shard or not batch_ok) and data > 1 \
                    and shape[seq_dim] % (data * tp) == 0:
                s[seq_dim] = (("model", "data") if s[seq_dim] == "model"
                              else "data" if s[seq_dim] is None
                              else s[seq_dim])
        elif name in _LATENT_LEAVES and len(shape) >= 3:
            seq_dim = nstack + 1
            if tp > 1 and shape[seq_dim] % tp == 0:
                s[seq_dim] = "model"
            if (seq_shard or not batch_ok) and data > 1 \
                    and shape[seq_dim] % (tp * data) == 0:
                s[seq_dim] = ("model", "data") if tp > 1 else "data"
        elif name == "ssm" and tp > 1 and len(shape) > nstack + 2 \
                and shape[nstack + 1] % tp == 0:
            s[nstack + 1] = "model"                  # the SSM heads
        return P(*s)

    return tree_map_with_path(spec, cache_shapes)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None → ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh
                ) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    axis = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[d] //= axis[a]
    return tuple(out)


def to_named(specs: PyTree, mesh) -> PyTree:
    """``(mesh, spec)`` per leaf: the port's ``NamedSharding``."""
    return tree_map_with_path(lambda _, s: (mesh, s), specs)
