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
#: the expert-parallel MoE
TP_ARCHS = ("zamba2-1.2b", "gemma-2b", "deepseek-moe-16b")

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

def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree

rank, world, store, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
start_group("gloo", rank, world, store, timeout_s=120)
mesh = make_debug_mesh(world)
out = {}

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
        params, opt, loss, _ = step(params, opt, train_batch(
            step.cfg, {B}, {S}, seed=i, device="cpu"))
        losses.append(loss.item())
        if i == 0:                      # the first step's summed gradients
            grads = step.gather_params(shd.tree_map_with_path(
                lambda path, _: leaf(params, path).grad, step.specs[0]))
    full = step.gather_params(params)
    tag = "fsdp" if fsdp else "tp"
    out[tag] = dict(losses=losses, report=step.shard_report.summary(),
                    local_numel=sum(p.numel() for p in params.parameters()),
                    collectives=dict(coll.COLLECTIVE_BYTES),
                    constrained=dict(context.CONSTRAINED))
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
seen = {"flash": set(), "ssm": set()}
_fa, _ssd = attn_mod.flash_attention, m2_mod.ssd_chunked_kernel
def _seen_fa(q, *a, **k):
    seen["flash"].add(q.shape[2])
    return _fa(q, *a, **k)
def _seen_ssd(x, *a, **k):
    seen["ssm"].add(x.shape[2])
    return _ssd(x, *a, **k)
attn_mod.flash_attention, m2_mod.ssd_chunked_kernel = _seen_fa, _seen_ssd
for arch in {TP_ARCHS}:
    c = reduced_config(arch).replace(dtype="float32")
    if c.num_experts:
        c = c.replace(capacity_factor=4.0)
    seen["flash"].clear(), seen["ssm"].clear()
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
    "{N}", str(N_ENVS)).replace("{TP_ARCHS}", repr(TP_ARCHS))

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


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_families_match_one_process(run, arch):
    """Each "model" rank computes with its half of the heads (flash
    attention and ssm_scan see half of them), and nothing but the
    matrices that have no head or unit dim runs whole; 2 train steps'
    losses within 1e-5 relative, and a prefill and two decode steps'
    logits within 1e-5 of max |logit|, of the port's single process."""
    io, ranks = run
    got = ranks[0]["tp_" + arch]
    cfg = p_reduced(arch).replace(dtype="float32")
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=4.0)
    assert got["heads"]["flash"] == [cfg.num_heads // 2]
    if cfg.family == "hybrid":
        assert got["heads"]["ssm"] == [cfg.n_ssm_heads // 2]
    whole = {"hybrid": ["mamba/conv_b_w", "mamba/conv_c_w", "mamba/w_b",
                        "mamba/w_c"],
             "moe": ["layers/moe/router", "layers/moe/w_down",
                     "layers/moe/w_gate", "layers/moe/w_up"]}
    assert got["tp_compute"]["whole"] == whole.get(cfg.family, [])
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
    from repro_torch.data.synthetic import prefill_batch
    params = api.init_params(0, "cpu")
    tok = torch.tensor([[1], [2], [3], [4]])
    with torch.no_grad():
        lg, cache = api.prefill(params, prefill_batch(cfg, 4, 12, seed=0,
                                                      device="cpu"), 16)
        lg1, cache = api.decode_step(params, {"token": tok}, cache)
        lg2, cache = api.decode_step(params, {"token": tok + 1}, cache)
    want = torch.cat([lg, lg1, lg2], 1)
    served = torch.load(io / f"tp_{arch}.pt")
    assert served.shape == want.shape
    assert (served - want).abs().max() <= TRAIN_TOL * want.abs().max()
