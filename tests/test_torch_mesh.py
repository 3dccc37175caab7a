"""The port's mesh path on 4 ``gloo`` ranks on the CPU, a (2, 2)
("data", "model") mesh, against the reference.

One module-scoped fixture runs the ranks once (each a process with a
timeout) and a second subprocess runs the reference's expert-parallel MoE
layer on a (2, 2) mesh of 4 forced host devices.  Held:

  * reduced qwen3-1.7b in f32, 3 ``assemble`` train steps at B 8, S 64
    from the reference's init (``params_from_jax``), with and without FSDP:
    losses equal the port's single-process step and the reference's
    single-device jitted ``build_train_step(api, adamw(1e-4))`` within 1e-5
    relative (GSPMD does not change the maths; the reference's sharded
    step fails on this jax, ROADMAP §3); final parameters within 1e-5 of
    each leaf's max |value| of the port's single process, and within 1e-5
    of each leaf's norm of the reference's;
  * reduced deepseek-moe-16b's ``moe_mlp`` (4 experts, so tp = 2 takes the
    expert-parallel branch) where capacity drops choices: equal to the
    reference's ``shard_map`` branch within 1e-5 of max |y|; and 2 train
    steps of the model without drops against the port's single process;
  * ``decide_all_sharded(mesh=)`` at 13 envs (padded to 16, trimmed): bit
    for bit the reference's numpy ``decide_all`` (its own sharded sweep
    needs ``enable_x64``, which this jax lacks);
  * a prefill and a decode step of reduced qwen3-1.7b on the mesh: the
    single-process port's logits within 1e-5.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.hw import get_device as r_get
from repro.launch.steps import build_train_step as r_build_train_step
from repro.models import build_model as r_build_model
from repro.models import moe as r_moe
from repro.models.layers import init_tree as r_init_tree
from repro.optim import adamw as r_adamw

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.data.synthetic import train_batch
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
TIMEOUT_S = 300
STEPS, B, S = 3, 8, 64
TRAIN_TOL = 1e-5                    # relative, of each leaf's max |value|
MOE_TOL = 1e-5                      # of max |y|
MOE_CAPACITY_FACTOR = 0.5           # small enough that capacity drops
N_ENVS = 13
#: reduced configs run with their heads split over "model" (tp = 2): Mamba2
#: heads into ssm_scan, a key/value head shared by both "model" ranks with
#: a tied vocabulary-parallel head, attention and shared experts beside
#: the expert-parallel MoE, the xLSTM's mLSTM and sLSTM heads (slstm_scan)
#: with its up projection pinned whole, as xlstm-350m sets it, and split
#: (its x_in gathered), whisper's encoder, self- and cross-attention and
#: MLPs
TP_ARCHS = ("zamba2-1.2b", "gemma-2b", "deepseek-moe-16b", "xlstm-350m",
            "whisper-tiny")
#: case -> (arch, config overrides)
TP_CASES = {**{a: (a, {}) for a in TP_ARCHS},
            "xlstm-350m-unpinned": ("xlstm-350m",
                                    {"xlstm_pin_inner": False})}
#: decode steps whose cache spec splits the sequence: (tag, arch, config
#: overrides, batch)
SEQ_DECODES = (("gemma_b2", "gemma-2b", {}, 2),
               ("gemma_b1", "gemma-2b", {}, 1),
               ("mla_naive", "deepseek-v2-lite-16b", {"mla_absorbed": False}, 2),
               ("mla_absorbed", "deepseek-v2-lite-16b", {"mla_absorbed": True},
                2))

WORKER = r'''
import os, sys, json
import numpy as np
import torch
from repro_torch.configs import reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.data.synthetic import prefill_batch, train_batch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context
from repro_torch.distributed import sharding as shd
from repro_torch.hw import get_device
from repro_torch.launch.mesh import axis_mapping_for, make_debug_mesh, start_group
from repro_torch.launch.steps import assemble
from repro_torch.models import build_model, moe
from repro_torch.sim.fleet import decide_all_sharded
SEQ_DECODES = {SEQ_DECODES}

def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree

rank, world, store, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
start_group("gloo", rank, world, store, timeout_s=120)
mesh = make_debug_mesh(world)
out = {}

# what the collectives move and the residual stream holds, while `record`
# is on: the shapes of all-reduces (not gloo's reduce-scatter, a sum then a
# slice) and all-gathers, activation_sp rows
from repro_torch.models import transformer as tf_mod
record = {"on": False, "reduce": [], "gather": [], "sp_rows": set()}
_red, _gat, _con = coll._reduce, coll._gather, tf_mod.constrain
def _rec_red(x, *a, **k):
    if record["on"]:
        record["reduce"].append(list(x.shape))
    return _red(x, *a, **k)
def _rec_gat(x, *a, **k):
    y = _gat(x, *a, **k)
    if record["on"]:
        record["gather"].append(list(y.shape))
    return y
def _rec_con(x, name):
    if record["on"] and name == "activation_sp":
        record["sp_rows"].add(x.shape[1])
    return _con(x, name)
coll._reduce, coll._gather, tf_mod.constrain = _rec_red, _rec_gat, _rec_con
def recorded():
    out = {"reduce": record["reduce"][:], "gather": record["gather"][:],
           "sp_rows": sorted(record["sp_rows"])}
    record["reduce"].clear(), record["gather"].clear(), record["sp_rows"].clear()
    return out

# -- train: reduced qwen3-1.7b in f32, with and without FSDP -------------
cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
for fsdp in (False, True):
    if fsdp:
        os.environ["REPRO_FORCE_FSDP"] = "1"
    else:
        os.environ.pop("REPRO_FORCE_FSDP", None)
    coll.reset_counts()
    context.CONSTRAINED.clear()
    step = assemble(cfg, InputShape("t", {S}, {B}, "train"), mesh)
    params = step.shard_params(torch.load(os.path.join(io, "qwen3.pt"),
                                          weights_only=False))
    params.requires_grad_(True)
    opt, losses = None, []
    for i in range({STEPS}):
        record["on"] = i == 0
        params, opt, loss, _ = step(params, opt, train_batch(
            step.cfg, {B}, {S}, seed=i, device="cpu"))
        record["on"] = False
        if i == 0:
            sp_record = recorded()
        losses.append(loss.item())
        if i == 0:                      # the first step's summed gradients
            grads = step.gather_params(shd.tree_map_with_path(
                lambda path, _: leaf(params, path).grad, step.specs[0]))
    full = step.gather_params(params)
    tag = "fsdp" if fsdp else "tp"
    out[tag] = dict(losses=losses, report=step.shard_report.summary(),
                    local_numel=sum(p.numel() for p in params.parameters()),
                    collectives=dict(coll.COLLECTIVE_BYTES),
                    constrained=dict(context.CONSTRAINED),
                    seq_parallel=step.cfg.seq_parallel, **sp_record)
    if rank == 0:
        torch.save({k: v.detach() for k, v in full.named_parameters()},
                   os.path.join(io, f"train_{tag}.pt"))
        torch.save(dict(grads.named_parameters()),
                   os.path.join(io, f"grads_{tag}.pt"))

# -- the expert-parallel MoE layer trained: no drops, so the single step --
mcfg = reduced_config("deepseek-moe-16b").replace(dtype="float32",
                                                 capacity_factor=4.0)
step = assemble(mcfg, InputShape("t", 16, 8, "train"), mesh)
params = step.shard_params(build_model(mcfg).init_params(0, "cpu"))
params.requires_grad_(True)
opt, losses = None, []
for i in range(2):
    params, opt, loss, _ = step(params, opt, train_batch(mcfg, 8, 16, seed=i,
                                                         device="cpu"))
    losses.append(loss.item())
full = step.gather_params(params)
out["moe_train"] = losses
if rank == 0:
    torch.save({k: v.detach() for k, v in full.named_parameters()},
               os.path.join(io, "moe_train.pt"))

# -- the expert-parallel MoE trained with sequence parallelism forced on ----
mcfg = reduced_config("deepseek-moe-16b").replace(dtype="float32",
                                                 capacity_factor=4.0)
step = assemble(mcfg, InputShape("t", 16, 8, "train"), mesh,
                extra_cfg_kw={"seq_parallel": True})
params = step.shard_params(build_model(mcfg).init_params(0, "cpu"))
params.requires_grad_(True)
opt, losses = None, []
for i in range(2):
    record["on"] = i == 0
    params, opt, loss, _ = step(params, opt, train_batch(mcfg, 8, 16, seed=i,
                                                         device="cpu"))
    record["on"] = False
    if i == 0:
        moe_sp = recorded()
    losses.append(loss.item())
full = step.gather_params(params)
out["moe_sp_train"] = dict(losses=losses, seq_parallel=step.cfg.seq_parallel,
                           **moe_sp)
if rank == 0:
    torch.save({k: v.detach() for k, v in full.named_parameters()},
               os.path.join(io, "moe_sp_train.pt"))

# -- decode on sequence-split caches: gemma-2b (its one key/value head) at
#    B 2 (the sequence over "model") and B 1 (over "model" x "data"), and
#    deepseek-v2-lite-16b's latent cache, naive and absorbed --------------
for tag, arch, kw, b in SEQ_DECODES:
    c = reduced_config(arch).replace(dtype="float32", **kw)
    if c.num_experts:
        c = c.replace(capacity_factor=4.0)
    pf = assemble(c, InputShape("p", 16, b, "prefill"), mesh)
    dc = assemble(c, InputShape("d", 16, b, "decode"), mesh)
    params = pf.shard_params(build_model(c).init_params(0, "cpu"))
    tok = torch.arange(1, b + 1)[:, None]
    with torch.no_grad():
        lg, cache = pf(params, prefill_batch(c, b, 12, seed=0, device="cpu"))
        record["on"] = True
        lg1, cache = dc(params, {"token": tok}, cache)
        lg2, cache = dc(params, {"token": tok + 1}, cache)
        record["on"] = False
    seen_dec = recorded()
    parts = [lg, lg1, lg2]
    if b % 2 == 0:
        parts = [coll.all_gather(x, mesh, ("data",), 0) for x in parts]
    leaf = {k: list(v.shape) for k, v in cache["layers"].items()}
    out["seq_" + tag] = dict(gather=seen_dec["gather"], block=leaf,
                             cache_spec={k: [list(shd.entry_axes(e)) for e in v]
                                         for k, v in dc.specs[2]["layers"].items()})
    if rank == 0:
        torch.save(torch.cat(parts, 1), os.path.join(io, f"seq_{tag}.pt"))

# -- the expert-parallel MoE layer ----------------------------------------
mcfg = reduced_config("deepseek-moe-16b").replace(
    dtype="float32", capacity_factor={CF})
moe_in = torch.load(os.path.join(io, "moe.pt"), weights_only=False)
with context.axis_mapping(axis_mapping_for(mesh), mesh=mesh):
    y, aux = moe.moe_mlp(moe_in["params"], moe_in["x"], mcfg)
out["moe_aux"] = aux.item()
if rank == 0:
    torch.save(y, os.path.join(io, "moe_y.pt"))

# -- the sharded decision sweep --------------------------------------------
layers = off.transformer_layer_costs(reduced_config("qwen3-1.7b"), 64, 1)
devs = [get_device(n) for n in ("pi5-arm", "jetson-orin-nano", "gtx-1650")]
envs = dec.make_envs([devs[i % 3] for i in range({N})],
                     get_device("edge-server-a100"),
                     link_bw=np.geomspace(1e5, 8e9, {N}),
                     link_latency_s=0.005, input_bytes=4 * 4096, device="cpu")
plan = decide_all_sharded(layers, envs, mesh=mesh)
if rank == 0:
    torch.save({f: getattr(plan, f) for f in ("splits", "total_time_s",
                "device_time_s", "transfer_time_s", "edge_time_s")},
               os.path.join(io, "plan.pt"))

# -- prefill and one decode step on the mesh --------------------------------
pf = assemble(cfg, InputShape("p", 16, 4, "prefill"), mesh)
dc = assemble(cfg, InputShape("d", 16, 4, "decode"), mesh)
params = pf.shard_params(torch.load(os.path.join(io, "qwen3.pt"),
                                    weights_only=False))
batch = prefill_batch(cfg, 4, 12, seed=0, device="cpu")
logits, cache = pf(params, batch)
logits1, cache = dc(params, {"token": torch.tensor([[1], [2], [3], [4]])},
                    cache)
both = torch.cat([coll.all_gather(logits, mesh, ("data",), 0),
                  coll.all_gather(logits1, mesh, ("data",), 0)], 1)
if rank == 0:
    torch.save(both, os.path.join(io, "serve.pt"))

# -- tensor parallelism across families: the heads each kernel sees --------
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2_mod
from repro_torch.models import xlstm as xl_mod
seen = {"flash": set(), "ssm": set(), "slstm": set()}
_fa, _ssd = attn_mod.flash_attention, m2_mod.ssd_chunked_kernel
_sl = xl_mod.slstm_scan_op
def _seen_fa(q, *a, **k):
    seen["flash"].add(q.shape[2])
    return _fa(q, *a, **k)
def _seen_ssd(x, *a, **k):
    seen["ssm"].add(x.shape[2])
    return _ssd(x, *a, **k)
def _seen_sl(pre, r, *a, **k):
    seen["slstm"].add(r.shape[1])
    return _sl(pre, r, *a, **k)
attn_mod.flash_attention, m2_mod.ssd_chunked_kernel = _seen_fa, _seen_ssd
xl_mod.slstm_scan_op = _seen_sl
for arch, (name, kw) in {TP_CASES}.items():
    c = reduced_config(name).replace(dtype="float32", **kw)
    if c.num_experts:
        c = c.replace(capacity_factor=4.0)
    for v in seen.values():
        v.clear()
    p0 = build_model(c).init_params(0, "cpu")
    tr = assemble(c, InputShape("t", 16, 4, "train"), mesh, auto_knobs=False)
    params = tr.shard_params(p0).requires_grad_(True)
    opt, losses = None, []
    for i in range(2):
        params, opt, loss, _ = tr(params, opt, train_batch(c, 4, 16, seed=i,
                                                           device="cpu"))
        losses.append(loss.item())
    pf = assemble(c, InputShape("p", 16, 4, "prefill"), mesh)
    dc = assemble(c, InputShape("d", 16, 4, "decode"), mesh)
    # a fresh init: the train steps updated p0's whole leaves in place
    params = pf.shard_params(build_model(c).init_params(0, "cpu"))
    tok = torch.tensor([[1], [2], [3], [4]])
    with torch.no_grad():
        lg, cache = pf(params, prefill_batch(c, 4, 12, seed=0, device="cpu"))
        lg1, cache = dc(params, {"token": tok}, cache)
        lg2, cache = dc(params, {"token": tok + 1}, cache)
    got = torch.cat([coll.all_gather(x, mesh, ("data",), 0)
                     for x in (lg, lg1, lg2)], 1)
    out["tp_" + arch] = dict(losses=losses, tp_compute=tr.tp_compute,
                             heads={k: sorted(v) for k, v in seen.items()})
    if rank == 0:
        torch.save(got, os.path.join(io, f"tp_{arch}.pt"))

with open(os.path.join(io, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
'''.replace("{S}", str(S)).replace("{B}", str(B)).replace(
    "{STEPS}", str(STEPS)).replace("{CF}", str(MOE_CAPACITY_FACTOR)).replace(
    "{N}", str(N_ENVS)).replace("{TP_CASES}", repr(TP_CASES)).replace(
    "{SEQ_DECODES}", repr(SEQ_DECODES))

REF_MOE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs import reduced_config
from repro.distributed.context import axis_mapping
from repro.launch.mesh import axis_mapping_for
from repro.models import moe

io = sys.argv[1]
data = np.load(os.path.join(io, "moe_ref_in.npz"))
params = {k[2:]: v for k, v in data.items() if k.startswith("p_")}
params["shared"] = {k[2:]: v for k, v in data.items() if k.startswith("s_")}
cfg = reduced_config("deepseek-moe-16b").replace(dtype="float32",
                                                 capacity_factor=float(sys.argv[2]))
mesh = jax.make_mesh((2, 2), ("data", "model"))
with mesh, axis_mapping(axis_mapping_for(mesh), mesh=mesh):
    y, aux = jax.jit(lambda p, x: moe.moe_mlp(p, x, cfg))(params, data["x"])
np.savez(os.path.join(io, "moe_ref_out.npz"), y=np.asarray(y),
         aux=np.asarray(aux))
'''


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    io = tmp_path_factory.mktemp("mesh")
    # the reference's inits, and the port's copies of them
    rcfg = r_reduced("qwen3-1.7b").replace(dtype="float32")
    pcfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    rparams = r_build_model(rcfg).init_params(jax.random.key(0))
    torch.save(params_from_jax(pcfg, rparams, "cpu"), io / "qwen3.pt")
    mcfg = r_reduced("deepseek-moe-16b").replace(dtype="float32")
    mp = r_init_tree(jax.random.key(1), r_moe.moe_param_shapes(mcfg),
                     jnp.float32)
    x = np.random.default_rng(2).normal(size=(4, 16, mcfg.d_model)
                                        ).astype(np.float32)
    np.savez(io / "moe_ref_in.npz", x=x,
             **{f"p_{k}": np.asarray(v) for k, v in mp.items()
                if k != "shared"},
             **{f"s_{k}": np.asarray(v) for k, v in mp["shared"].items()})
    tt = {k: (torch.from_numpy(np.array(v)) if k != "shared" else
              {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in mp.items()}
    torch.save({"params": tt, "x": torch.from_numpy(x)}, io / "moe.pt")
    (io / "worker.py").write_text(WORKER)
    (io / "ref_moe.py").write_text(REF_MOE)

    ref = subprocess.Popen([sys.executable, str(io / "ref_moe.py"), str(io),
                            str(MOE_CAPACITY_FACTOR)], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ranks = [subprocess.Popen([sys.executable, str(io / "worker.py"),
                               str(r), str(RANKS), str(io / "store"),
                               str(io)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    errors = []
    for p in ranks + [ref]:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in ranks + [ref]:
                q.kill()
            raise
        if p.returncode:
            errors.append(err[-3000:])
    assert not errors, "\n".join(errors)
    return io, [json.loads((io / f"rank{r}.json").read_text())
                for r in range(RANKS)]


def _single_process_runs():
    """The port's single-process step and the reference's single-device
    jitted step, 3 steps each from the same init: (losses, params)."""
    rcfg = r_reduced("qwen3-1.7b").replace(dtype="float32")
    pcfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    rapi = r_build_model(rcfg)
    rparams = rapi.init_params(jax.random.key(0))
    pparams = params_from_jax(pcfg, rparams, "cpu").requires_grad_(True)
    from repro.data.synthetic import train_batch as r_train_batch
    ropt = r_adamw(1e-4)
    rstep = jax.jit(r_build_train_step(rapi, ropt))
    rstate, rlosses = ropt.init(rparams), []
    pstep = build_train_step(build_model(pcfg), lambda ps: AdamW(ps, 1e-4))
    popt, plosses, pgrads = None, [], None
    for i in range(STEPS):
        rparams, rstate, loss, _ = rstep(rparams, rstate,
                                         r_train_batch(rcfg, B, S, seed=i))
        rlosses.append(float(loss))
        pparams, popt, loss, _ = pstep(pparams, popt,
                                       train_batch(pcfg, B, S, seed=i,
                                                   device="cpu"))
        plosses.append(loss.item())
        if i == 0:
            pgrads = {n: p.grad.clone() for n, p in
                      pparams.named_parameters()}
    return (rlosses, params_from_jax(pcfg, rparams, "cpu")), \
        (plosses, pparams, pgrads)


@pytest.fixture(scope="module")
def single():
    return _single_process_runs()


@pytest.mark.parametrize("tag", ["tp", "fsdp"])
def test_sharded_train_steps_match_single_device(run, single, tag):
    io, ranks = run
    got = torch.load(io / f"train_{tag}.pt")
    losses = ranks[0][tag]["losses"]
    assert all(r[tag]["losses"] == losses for r in ranks)
    (ref_losses, ref), (port_losses, port, port_grads) = single
    np.testing.assert_allclose(losses, ref_losses, rtol=TRAIN_TOL)
    np.testing.assert_allclose(losses, port_losses, rtol=TRAIN_TOL)
    grads = torch.load(io / f"grads_{tag}.pt")
    for name, w in port.named_parameters():
        w, r = w.detach(), dict(ref.named_parameters())[name].detach()
        # the first step's gradient against the port's single process:
        # every element, of max |g|
        g = port_grads[name]
        err = (grads[name] - g).abs().max().item() / g.abs().max().item()
        assert err <= TRAIN_TOL, (tag, name, "grad", err)
        # the parameters after 3 steps, against the port's single process
        # and the reference: the leaf's norm.  AdamW's update is
        # ~lr·sign(g) where g is near 0, so f32 sums in another order (the
        # "model" ranks' partial products) move such elements by up to
        # 2·lr: the port's own single process sits 2.2e-5 of max |w| off
        # the reference on some elements
        for want in (w, r):
            err = ((got[name] - want).norm() / want.norm()).item()
            assert err <= TRAIN_TOL, (tag, name, err)
    # FSDP shards more: each rank holds fewer elements
    if tag == "fsdp":
        assert ranks[0]["fsdp"]["local_numel"] < ranks[0]["tp"]["local_numel"]
        assert ranks[0]["fsdp"]["report"] != ranks[0]["tp"]["report"]


def test_sharded_train_issues_collectives_and_hits_constraints(run):
    _, ranks = run
    for tag in ("tp", "fsdp"):
        c = ranks[0][tag]["collectives"]
        assert c["all-gather"] > 0 and c["reduce-scatter"] > 0, c
        assert c["all-reduce"] > 0, c
        # the residual stream (seq_parallel on: tp 2 divides S) and logits
        assert set(ranks[0][tag]["constrained"]) >= {"activation",
                                                     "activation_sp",
                                                     "logits"}


def test_expert_parallel_moe_trains_as_one_process(run):
    """reduced deepseek-moe-16b, 2 steps at B 8, S 16 with no capacity
    drops (factor 4): the experts split over "model", the batch and the
    aux loss's means over "data"; losses within 1e-5 relative and each
    parameter leaf within 1e-5 of its norm of the port's single
    process."""
    io, ranks = run
    cfg = p_reduced("deepseek-moe-16b").replace(dtype="float32",
                                                capacity_factor=4.0)
    api = build_model(cfg)
    params = api.init_params(0, "cpu", trainable=True)
    step = build_train_step(api, lambda ps: AdamW(ps, 1e-4))
    opt, losses = None, []
    for i in range(2):
        params, opt, loss, _ = step(params, opt, train_batch(
            cfg, 8, 16, seed=i, device="cpu"))
        losses.append(loss.item())
    assert all(r["moe_train"] == ranks[0]["moe_train"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["moe_train"], losses,
                               rtol=TRAIN_TOL)
    got = torch.load(io / "moe_train.pt")
    for name, w in params.named_parameters():
        # each leaf's norm: the experts' partial outputs meet in another
        # order, and AdamW moves an element whose gradient is near 0 by
        # up to 2·lr either way (the gradients themselves agree to 8e-7
        # of their max)
        w = w.detach()
        err = ((got[name] - w).norm() / w.norm()).item()
        assert err <= TRAIN_TOL, (name, err)


def test_expert_parallel_moe_matches_reference_shard_map(run):
    io, ranks = run
    ref = np.load(io / "moe_ref_out.npz")
    got = torch.load(io / "moe_y.pt").numpy()
    scale = np.abs(ref["y"]).max()
    assert np.abs(got - ref["y"]).max() <= MOE_TOL * scale
    np.testing.assert_allclose([r["moe_aux"] for r in ranks],
                               float(ref["aux"]), rtol=1e-6)
    # capacity drops: a token's choices past its shard's capacity
    mcfg = r_reduced("deepseek-moe-16b").replace(
        dtype="float32", capacity_factor=MOE_CAPACITY_FACTOR)
    data = np.load(io / "moe_ref_in.npz")
    x = data["x"].reshape(-1, mcfg.d_model)
    _, idx, _ = r_moe.route({"router": data["p_router"]}, x, mcfg)
    half = x.shape[0] // 2
    cap = r_moe.capacity(half, mcfg)
    drops = sum(int(np.maximum(np.bincount(np.asarray(idx[i:i + half])
                                           .ravel(), minlength=4) - cap,
                               0).sum()) for i in (0, half))
    assert drops > 0


def test_sharded_sweep_is_numpy_decide_all_bit_for_bit(run):
    io, _ = run
    got = torch.load(io / "plan.pt")
    from repro.configs import reduced_config as rr
    layers = roff.transformer_layer_costs(rr("qwen3-1.7b"), 64, 1)
    devs = [r_get(n) for n in ("pi5-arm", "jetson-orin-nano", "gtx-1650")]
    envs = rdec.make_envs([devs[i % 3] for i in range(N_ENVS)],
                          r_get("edge-server-a100"),
                          link_bw=np.geomspace(1e5, 8e9, N_ENVS),
                          link_latency_s=0.005, input_bytes=4 * 4096)
    want = rdec.decide_all(layers, envs)
    for f, g in got.items():
        assert g.shape == (N_ENVS,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want,
                                                                    f)))


def test_prefill_and_decode_on_the_mesh_match_one_process(run):
    io, _ = run
    got = torch.load(io / "serve.pt")
    cfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    api = build_model(cfg)
    params = torch.load(io / "qwen3.pt", weights_only=False)
    from repro_torch.data.synthetic import prefill_batch
    batch = prefill_batch(cfg, 4, 12, seed=0, device="cpu")
    with torch.no_grad():
        logits, cache = api.prefill(params, batch, 16)
        logits1, _ = api.decode_step(params, {"token": torch.tensor(
            [[1], [2], [3], [4]])}, cache)
    want = torch.cat([logits, logits1], 1)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


#: the matrices each family computes whole on every "model" rank at tp 2
WHOLE = {"hybrid": ["mamba/conv_b_w", "mamba/conv_c_w", "mamba/w_b",
                    "mamba/w_c"],
         "moe": ["layers/moe/router", "layers/moe/w_down",
                 "layers/moe/w_gate", "layers/moe/w_up"],
         "ssm": ["mlstm/conv_w", "mlstm/w_up", "slstm/conv_w"]}


@pytest.mark.parametrize("arch", list(TP_CASES))
def test_tensor_parallel_families_match_one_process(run, arch):
    """Each "model" rank computes with its half of the heads (flash
    attention, ssm_scan and slstm_scan see half of them), and nothing but
    the matrices that have no head or unit dim runs whole (the xLSTM's
    depthwise convolutions, and its up projection where it is pinned);
    2 train steps' losses within 1e-5 relative, and a prefill and two
    decode steps' logits within 1e-5 of max |logit|, of the port's single
    process."""
    io, ranks = run
    got = ranks[0]["tp_" + arch]
    name, kw = TP_CASES[arch]
    cfg = p_reduced(name).replace(dtype="float32", **kw)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=4.0)
    half = cfg.num_heads // 2
    assert got["heads"]["flash"] == ([] if cfg.family == "ssm" else [half])
    assert got["heads"]["slstm"] == ([half] if cfg.family == "ssm" else [])
    if cfg.family == "hybrid":
        assert got["heads"]["ssm"] == [cfg.n_ssm_heads // 2]
    whole = WHOLE.get(cfg.family, [])
    if cfg.family == "ssm" and not cfg.xlstm_pin_inner:
        whole = [w for w in whole if w != "mlstm/w_up"]
    assert got["tp_compute"]["whole"] == whole
    assert all(r["tp_" + arch]["losses"] == got["losses"] for r in ranks)
    api = build_model(cfg)
    params = api.init_params(0, "cpu", trainable=True)
    step = build_train_step(api, lambda ps: AdamW(ps, 1e-4))
    opt, losses = None, []
    for i in range(2):
        params, opt, loss, _ = step(params, opt, train_batch(
            cfg, 4, 16, seed=i, device="cpu"))
        losses.append(loss.item())
    np.testing.assert_allclose(got["losses"], losses, rtol=TRAIN_TOL)
    params = api.init_params(0, "cpu")
    tok = torch.tensor([[1], [2], [3], [4]])
    want = _one_process_serve(api, params, cfg, 4, tok)
    served = torch.load(io / f"tp_{arch}.pt")
    assert served.shape == want.shape
    assert (served - want).abs().max() <= TRAIN_TOL * want.abs().max()


def _one_process_serve(api, params, cfg, b, tok):
    """A 12-token prefill (cache of 16) and two decode steps' logits."""
    from repro_torch.data.synthetic import prefill_batch
    with torch.no_grad():
        lg, cache = api.prefill(params, prefill_batch(cfg, b, 12, seed=0,
                                                      device="cpu"), 16)
        lg1, cache = api.decode_step(params, {"token": tok}, cache)
        lg2, cache = api.decode_step(params, {"token": tok + 1}, cache)
    return torch.cat([lg, lg1, lg2], 1)


@pytest.mark.parametrize("tag", ["tp", "fsdp"])
def test_sequence_parallel_residual_holds_its_rows(run, tag):
    """qwen3-1.7b's train step (S 64; seq_parallel set by the step, as tp
    2 divides S): the residual stream between layers holds S/2 rows a
    rank, and no [B, S, d] tensor is all-reduced (the row-parallel
    products end in reduce-scatters, the embedding's sum too)."""
    _, ranks = run
    got = ranks[0][tag]
    d = p_reduced("qwen3-1.7b").d_model
    assert got["seq_parallel"]
    assert got["sp_rows"] == [S // 2]
    assert [B // 2, S, d] not in got["reduce"]
    assert [B // 2, S, d] in got["gather"]


def test_sequence_parallel_moe_trains_as_one_process(run):
    """reduced deepseek-moe-16b with seq_parallel forced on (as the §Perf
    pair C's baseline does), 2 steps at B 8, S 16 without capacity drops:
    its residual holds S/2 rows a rank, the MoE input is gathered and its
    output reduce-scattered (no [B, S, d] all-reduce), and the losses and
    parameters match the port's single process as the expert-parallel
    test holds them."""
    io, ranks = run
    got = ranks[0]["moe_sp_train"]
    cfg = p_reduced("deepseek-moe-16b").replace(dtype="float32",
                                                capacity_factor=4.0)
    assert got["seq_parallel"] and got["sp_rows"] == [8]
    assert [4, 16, cfg.d_model] not in got["reduce"]
    assert all(r["moe_sp_train"]["losses"] == got["losses"] for r in ranks)
    api = build_model(cfg)
    params = api.init_params(0, "cpu", trainable=True)
    step = build_train_step(api, lambda ps: AdamW(ps, 1e-4))
    opt, losses = None, []
    for i in range(2):
        params, opt, loss, _ = step(params, opt, train_batch(
            cfg, 8, 16, seed=i, device="cpu"))
        losses.append(loss.item())
    np.testing.assert_allclose(got["losses"], losses, rtol=TRAIN_TOL)
    full = torch.load(io / "moe_sp_train.pt")
    for name, w in params.named_parameters():
        w = w.detach()
        err = ((full[name] - w).norm() / w.norm()).item()
        assert err <= TRAIN_TOL, (name, err)


@pytest.mark.parametrize("tag", [t[0] for t in SEQ_DECODES])
def test_sequence_split_decode_matches_one_process(run, tag):
    """A decode step whose cache spec splits the sequence (gemma-2b's one
    key/value head over "model", at B 1 over "model" x "data" too;
    deepseek-v2-lite-16b's latent cache over "model") keeps each rank's
    block: the stored block holds its share of the 16 slots, no cache
    leaf (nor a layer of it) is gathered whole (the distributed softmax
    moves the queries, the new key/value and its statistics; the naive
    MLA path its up-projections), and the logits of a prefill and two
    decode steps are within 1e-5 of max |logit| of the port's single
    process."""
    io, ranks = run
    _, arch, kw, b = next(t for t in SEQ_DECODES if t[0] == tag)
    got = ranks[0]["seq_" + tag]
    seq_axes = {k: v[2] for k, v in got["cache_spec"].items()}
    want_axes = ["model", "data"] if b == 1 else ["model"]
    assert all(v == want_axes for v in seq_axes.values()), seq_axes
    parts = 2 * len(want_axes)
    for name, shape in got["block"].items():
        assert shape[2] == 16 // parts, (name, shape)
        whole = shape[:2] + [16] + shape[3:]
        assert whole not in got["gather"], (name, got["gather"])
        assert whole[1:] not in got["gather"], (name, got["gather"])
    cfg = p_reduced(arch).replace(dtype="float32", **kw)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=4.0)
    api = build_model(cfg)
    tok = torch.arange(1, b + 1)[:, None]
    want = _one_process_serve(api, api.init_params(0, "cpu"), cfg, b, tok)
    served = torch.load(io / f"seq_{tag}.pt")
    assert served.shape == want.shape
    assert (served - want).abs().max() <= TRAIN_TOL * want.abs().max()


def test_card_mesh_module_on_cpu_ranks(tmp_path):
    """``launch.card_mesh``, the 4-process mesh chip_smoke runs on one card
    (gloo ranks sharing it), here on 4 gloo CPU ranks at the reduced
    configs: each part (qwen3 trained with sequence parallelism, gemma-2b
    and deepseek-v2-lite-16b decoding on sequence-split caches, the latter
    also with capacity drops taken per data rank, xlstm-350m and
    whisper-tiny trained and served with their heads split) against rank
    0's one process, losses and logits within 1e-5, gradients within 2e-5
    of their leaf's largest (``tests/test_torch_train.py``'s bar), every
    kernel seeing half the heads; qwen3's stream split by sequence (its
    row-parallel products reduce-scattered), and the drops changing the
    logits."""
    from repro_torch.launch import card_mesh
    procs = card_mesh.start(str(tmp_path), device="cpu", reduced=True)
    res = card_mesh.finish(procs, str(tmp_path), TIMEOUT_S)
    assert set(res["parts"]) == {"a_qwen3_sp", "b_gemma_b2", "b_gemma_b1",
                                 "c_mla_naive", "c_mla_absorbed",
                                 "c_mla_drops", "d_xlstm", "d_whisper"}
    for part, r in res["parts"].items():
        for key, tol in (("loss", TRAIN_TOL), ("logits", TRAIN_TOL),
                         ("grad", 2e-5)):
            assert r.get(key, 0.0) <= tol, (part, key, r.get(key))
        kind = "slstm" if part == "d_xlstm" else "flash"
        assert r["heads"][kind] == [2], (part, r["heads"])
    assert res["parts"]["a_qwen3_sp"]["seq_parallel"]
    assert res["parts"]["a_qwen3_sp"]["collectives"]["reduce-scatter"] > 0
    assert res["parts"]["c_mla_drops"]["drop_effect"] > 100 * TRAIN_TOL
