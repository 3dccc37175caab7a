"""Four ``gloo`` ranks on one card: the port's mesh step checked on the
device it computes on, against one process of the same model.

``nccl`` puts no two ranks on one device, so the (2, 2) ("data",
"model") mesh of this check is a ``gloo`` group whose four processes all
compute on ``cuda:0``; gloo moves the collectives on the card's
tensors.  Each part runs on the mesh, then
rank 0 runs the same model in one process on the same card and compares,
all in f32 with TF32 off, at full width and cut depth:

  * ``a_qwen3_sp`` — qwen3-1.7b (2 layers) trained 2 steps through
    ``assemble`` with sequence parallelism (tp 2 divides S) and the
    chunked loss: the losses and the first step's gradients;
  * ``b_gemma_b2`` / ``b_gemma_b1`` — gemma-2b (2 layers), whose one
    key/value head makes its cache spec split the sequence (over "model",
    and at B 1 over "model" × "data"): a prefill and 2 decode steps;
  * ``c_mla_naive`` / ``c_mla_absorbed`` — deepseek-v2-lite-16b (2
    layers): a prefill and 2 decode steps on its sequence-split latent
    cache, both decode paths, its MoE at capacity no load reaches;
  * ``c_mla_drops`` — the same model with capacity that drops tokens
    (``DROP_CAPACITY``): the mesh takes capacity per data rank's tokens,
    as the reference's ``shard_map`` does, so one process serves each row
    of the batch alone (a data rank's share) and the mesh is held to that;
    the whole batch in one process (capacity over all of it) must differ
    from it by ``drop_effect``, which shows that tokens were dropped;
  * ``d_xlstm`` / ``d_whisper`` — xlstm-350m (one group of 4 blocks) and
    whisper-tiny (2 + 2 layers): 2 train steps, then a prefill and 2
    decode steps, heads split over "model" (``slstm_scan`` and flash
    launched on the local heads).

Rank 0 writes ``card_mesh.json`` under the output directory: per part the
largest error (a loss's relative error, a gradient's over its leaf's max
|g|, logits over max |logit|), the kernels' launches in the mesh run and
the head counts the kernels saw, the collectives' bytes.  ``--reduced`` and ``--device cpu`` run the same on the CPU at the
reduced configs.

Run (one rank):  python -m repro_torch.launch.card_mesh --rank R \\
                     --world 4 --store PATH --out DIR [--device cpu]
From Python: ``procs = start(out)``, later ``finish(procs, out)``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from functools import partial

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.data.synthetic import prefill_batch, train_batch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (make_debug_mesh, make_shared_card_mesh,
                                     start_group)
from repro_torch.launch.steps import assemble
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.models import xlstm as xl_mod
from repro_torch.optim import AdamW
from repro_torch.train.loop import build_train_step

SEED = 0
WORLD = 4
RESULT = "card_mesh.json"
#: depth cut of each part's model (xLSTM: one group of its 4 blocks)
LAYERS = {"qwen3-1.7b": 2, "gemma-2b": 2, "deepseek-v2-lite-16b": 2,
          "xlstm-350m": 4, "whisper-tiny": 2}
TRAIN_SHAPE = (4, 256)            # (B, S) of part a
SMALL_TRAIN = (4, 128)            # (B, S) of part d
PROMPT, MAX_LEN, SERVE_B = 64, 128, 2
#: part c_mla_drops' capacity factor: a row's 64 tokens overflow it
DROP_CAPACITY = 0.5


def _cfg(arch: str, reduced: bool, **kw):
    """The part's config in f32 at its cut depth.  An MoE gets a capacity
    no expert's load can reach (E / k: each token picks an expert once)
    unless ``kw`` gives one, since the mesh takes capacity per rank's
    tokens, as the reference's ``shard_map`` does, and a drop differs from
    one process's on the whole batch."""
    if reduced:
        cfg = reduced_config(arch)
    else:
        cfg = get_config(arch).replace(num_layers=LAYERS[arch])
        if cfg.family == "audio":
            cfg = cfg.replace(enc_layers=LAYERS[arch])
    cfg = cfg.replace(dtype="float32", **kw)
    if cfg.num_experts and "capacity_factor" not in kw:
        cfg = cfg.replace(capacity_factor=float(
            math.ceil(cfg.num_experts / cfg.top_k)))
    return cfg


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _Seen:
    """The head counts the flash and ``slstm_scan`` wrappers are called
    with (the local heads on a mesh)."""

    def __init__(self):
        self.heads = {"flash": set(), "slstm": set()}
        self._fa, self._sl = attn_mod.flash_attention, xl_mod.slstm_scan_op

        def fa(q, *a, **k):
            self.heads["flash"].add(int(q.shape[2]))
            return self._fa(q, *a, **k)

        def sl(pre, r, *a, **k):
            self.heads["slstm"].add(int(r.shape[1]))
            return self._sl(pre, r, *a, **k)
        attn_mod.flash_attention, xl_mod.slstm_scan_op = fa, sl

    def take(self) -> dict:
        out = {k: sorted(v) for k, v in self.heads.items()}
        for v in self.heads.values():
            v.clear()
        return out


def _launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    return dict(**fa_kernel.flash_attention_kernel.by_kernel,
                flash_fwd_lse=fa_kernel.flash_attention_kernel.lse_launches,
                **fa_kernel.flash_attention_bwd_kernel.by_kernel,
                slstm_scan=sl_kernel.slstm_scan_kernel.launches,
                slstm_scan_bwd=sl_kernel.slstm_scan_bwd_kernel.launches)


def _reset_launches() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    fa_kernel.reset_counts()
    sl_kernel.reset_counts()


def _train(step, params, cfg, shape, dev):
    """2 steps of ``step`` (a mesh step or a one-process one): (losses,
    the first step's gradients by parameter name)."""
    opt, losses, grads = None, [], None
    b, s = shape
    for i in range(2):
        params, opt, loss, _ = step(params, opt, train_batch(
            cfg, b, s, seed=SEED + i, device=dev))
        losses.append(loss.item())
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in params.named_parameters()}
    return losses, grads


def _serve(pf, dc, params, cfg, b, dev, gather=None, row=None):
    """A prefill of PROMPT tokens and 2 decode steps: logits [B, 3, V]
    (over the mesh, gathered by ``gather``); ``row`` serves that row of
    the batch alone ([1, 3, V])."""
    tok = torch.arange(1, b + 1, device=dev)[:, None]
    batch = prefill_batch(cfg, b, PROMPT, seed=SEED, device=dev)
    if row is not None:
        tok = tok[row:row + 1]
        batch = {k: v[row:row + 1] for k, v in batch.items()}
    with torch.no_grad():
        lg, cache = pf(params, batch)
        lg1, cache = dc(params, {"token": tok}, cache)
        lg2, cache = dc(params, {"token": tok + 1}, cache)
    out = [lg, lg1, lg2]
    return torch.cat([gather(x) if gather else x for x in out], 1)


def _mesh_parts(mesh, dev, reduced: bool) -> tuple[dict, dict]:
    """Every part on the mesh: (its outputs, kept by rank 0, and its
    launches and heads)."""
    outs, info = {}, {}
    seen = _Seen()

    def data_gather(x):
        return coll.all_gather(x, mesh, ("data",), 0)

    def train_part(name, cfg, shape, **kw):
        step = assemble(cfg, InputShape(name, shape[1], shape[0], "train"),
                        mesh, **kw)
        params = step.shard_params(build_model(step.cfg).init_params(
            SEED, dev, trainable=True))
        opt, losses, grads = None, [], None
        for i in range(2):
            params, opt, loss, _ = step(params, opt, train_batch(
                step.cfg, shape[0], shape[1], seed=SEED + i, device=dev))
            losses.append(loss.item())
            if i == 0:
                grads = step.gather_params(shd.tree_map_with_path(
                    lambda path, _: _leaf(params, path).grad,
                    step.specs[0]))
        outs[name] = {"losses": losses, "cfg": step.cfg, "grads": {
            n: g.detach().cpu() for n, g in grads.named_parameters()}}

    def serve_part(name, cfg, b):
        pf = assemble(cfg, InputShape(name, MAX_LEN, b, "prefill"), mesh)
        dc = assemble(cfg, InputShape(name, MAX_LEN, b, "decode"), mesh)
        params = pf.shard_params(build_model(cfg).init_params(SEED, dev))
        outs[name] = _serve(pf, dc, params, cfg, b, dev,
                            data_gather if b % 2 == 0 else None).cpu()

    def part(name, fn):
        _reset_launches()
        coll.reset_counts()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        info[name] = dict(launches=_launches(), heads=seen.take(),
                          collectives=dict(coll.COLLECTIVE_BYTES),
                          seconds=time.perf_counter() - t0)

    def train_serve(name, cfg):
        train_part(name + "_train", cfg, SMALL_TRAIN, auto_knobs=False)
        serve_part(name, cfg, SERVE_B)

    qwen = _cfg("qwen3-1.7b", reduced)
    part("a_qwen3_sp", partial(train_part, "a_qwen3_sp", qwen,
                               SMALL_TRAIN if reduced else TRAIN_SHAPE))
    knobs = outs["a_qwen3_sp"]["cfg"]
    info["a_qwen3_sp"].update(seq_parallel=knobs.seq_parallel,
                              loss_chunk=knobs.loss_chunk)
    gemma = _cfg("gemma-2b", reduced)
    for b in (2, 1):
        part(f"b_gemma_b{b}", partial(serve_part, f"b_gemma_b{b}", gemma, b))
    for absorbed in (False, True):
        name = "c_mla_absorbed" if absorbed else "c_mla_naive"
        part(name, partial(serve_part, name, _cfg(
            "deepseek-v2-lite-16b", reduced, mla_absorbed=absorbed),
            SERVE_B))
    part("c_mla_drops", partial(serve_part, "c_mla_drops", _cfg(
        "deepseek-v2-lite-16b", reduced, capacity_factor=DROP_CAPACITY),
        SERVE_B))
    for arch, name in (("xlstm-350m", "d_xlstm"),
                       ("whisper-tiny", "d_whisper")):
        part(name, partial(train_serve, name, _cfg(arch, reduced)))
    return outs, info


def _one_process(outs: dict, dev, reduced: bool) -> dict:
    """Rank 0: every part in one process; the largest error of each."""
    errs = {}

    def grad_errs(got, want, family):
        scale = {n: w.abs().max().item() for n, w in want.items()}
        if family == "ssm":
            # the xLSTM's gate biases get gradients of rounding size (their
            # gates' stabiliser cancels them): each leaf is held to its
            # block's largest gradient, as the port's training tests do
            block: dict = {}
            for n, m in scale.items():
                key = n.rsplit(".", 1)[0]
                block[key] = max(block.get(key, 0.0), m)
            scale = {n: block[n.rsplit(".", 1)[0]] for n in scale}
        errs = {n: (got[n] - w.cpu()).abs().max().item()
                / max(scale[n], 1e-30) for n, w in want.items()}
        return dict(sorted(errs.items(), key=lambda kv: -kv[1])[:3])

    def loss_err(got, want):
        return max(abs(g - w) / abs(w) for g, w in zip(got, want))

    def train_one(name, shape):
        cfg = outs[name]["cfg"]             # the mesh step's knobs
        api = build_model(cfg)
        step = build_train_step(api, lambda ps: AdamW(ps, 1e-4))
        losses, grads = _train(step, api.init_params(SEED, dev,
                                                     trainable=True),
                               cfg, shape, dev)
        got = outs[name]
        worst = grad_errs(got["grads"], grads, cfg.family)
        return dict(loss=loss_err(got["losses"], losses),
                    grad=max(worst.values()), grad_worst=worst,
                    losses=got["losses"], want_losses=losses)

    def serve_one(name, cfg, b):
        api = build_model(cfg)
        want = _serve(lambda p, bt: api.prefill(p, bt, MAX_LEN),
                      api.decode_step, api.init_params(SEED, dev), cfg, b,
                      dev).cpu()
        got = outs[name]
        return dict(logits=((got - want).abs().max()
                            / want.abs().max()).item())

    def serve_rows(name, cfg, b):
        """Capacity per data rank's tokens: each of the B rows (one a data
        rank on the (2, 2) mesh) served alone; ``drop_effect`` is the whole
        batch's distance from that, capacity taken over all of it."""
        api = build_model(cfg)
        params = api.init_params(SEED, dev)

        def serve(row):
            return _serve(lambda p, bt: api.prefill(p, bt, MAX_LEN),
                          api.decode_step, params, cfg, b, dev,
                          row=row).cpu()
        want = torch.cat([serve(r) for r in range(b)], 0)
        scale = want.abs().max()
        return dict(logits=((outs[name] - want).abs().max() / scale).item(),
                    drop_effect=((serve(None) - want).abs().max()
                                 / scale).item())

    errs["a_qwen3_sp"] = train_one("a_qwen3_sp",
                                   SMALL_TRAIN if reduced else TRAIN_SHAPE)
    gemma = _cfg("gemma-2b", reduced)
    for b in (2, 1):
        errs[f"b_gemma_b{b}"] = serve_one(f"b_gemma_b{b}", gemma, b)
    for absorbed in (False, True):
        name = "c_mla_absorbed" if absorbed else "c_mla_naive"
        errs[name] = serve_one(name, _cfg("deepseek-v2-lite-16b", reduced,
                                          mla_absorbed=absorbed), SERVE_B)
    errs["c_mla_drops"] = serve_rows("c_mla_drops", _cfg(
        "deepseek-v2-lite-16b", reduced, capacity_factor=DROP_CAPACITY),
        SERVE_B)
    for arch, name in (("xlstm-350m", "d_xlstm"),
                       ("whisper-tiny", "d_whisper")):
        cfg = _cfg(arch, reduced)
        errs[name] = {**train_one(name + "_train", SMALL_TRAIN),
                      **serve_one(name, cfg, SERVE_B)}
    return errs


def run_rank(rank: int, world: int, store: str, out: str, device: str,
             reduced: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    start_group("gloo", rank, world, store)
    if device == "cuda":
        dev = torch.device("cuda", 0)
        mesh = make_shared_card_mesh(world)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        mesh = make_debug_mesh(world)
    outs, info = _mesh_parts(mesh, dev, reduced)
    mesh_s = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        return
    t1 = time.perf_counter()
    errs = _one_process(outs, dev, reduced)
    result = dict(parts={k: {**info.get(k, {}), **errs[k]} for k in errs},
                  mesh_s=mesh_s,
                  one_process_s=time.perf_counter() - t1,
                  device=torch.cuda.get_device_name(0)
                  if dev.type == "cuda" else "cpu")
    with open(os.path.join(out, RESULT), "w") as f:
        json.dump(result, f, indent=1)


def start(out: str, *, world: int = WORLD, device: str = "cuda",
          reduced: bool = False) -> list:
    """Start the ``world`` rank processes (their store a fresh file under
    ``out``); :func:`finish` waits for them."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, f"store_{os.getpid()}_{time.time_ns()}")
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "repro_torch.launch.card_mesh",
           "--world", str(world), "--store", store, "--out", out,
           "--device", device] + (["--reduced"] if reduced else [])
    return [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def finish(procs: list, out: str, timeout_s: float = 600.0) -> dict:
    """Wait for the ranks (killing all of them past ``timeout_s``); rank
    0's result, or a RuntimeError with the failed ranks' errors."""
    deadline = time.monotonic() + timeout_s
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise RuntimeError(f"card mesh: rank {r} past {timeout_s} s")
        if p.returncode:
            errors.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
    if errors:
        raise RuntimeError("card mesh: " + "\n".join(errors))
    with open(os.path.join(out, RESULT)) as f:
        return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("card_mesh: no card (use --device cpu)")
    run_rank(a.rank, a.world, a.store, a.out, a.device, a.reduced)


if __name__ == "__main__":
    main()
