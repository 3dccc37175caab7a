"""The port's partitioning rules against the reference's on the abstract
production meshes (16×16 and 2×16×16), with no devices: the six cases of
``tests/test_distribution.py``, every parameter leaf's spec for all ten
configs in training and serving (the reference's with its stack dims
dropped, since the port's parameters are per layer), the reports, the
cache and batch specs at the four input shapes, the two environment
levers, and ``model_flops_estimate``."""
import numpy as np
import pytest
from jax.sharding import AbstractMesh as RAbstractMesh

from repro.configs import ARCH_NAMES
from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.distributed import sharding as rshd
from repro.launch.steps import arch_shape_cfg as r_arch_shape_cfg
from repro.launch.steps import batch_input_specs as r_batch_input_specs
from repro.models import build_model as r_build_model
from repro.roofline import model_flops_estimate as r_model_flops

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import AbstractMesh, P
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import arch_shape_cfg, batch_input_specs
from repro_torch.models import build_model
from repro_torch.roofline import model_flops_estimate

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return RAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@pytest.fixture(scope="module")
def mesh16():
    return make_production_mesh()


def norm(spec):
    """A spec as a tuple, one-axis tuples as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def ref_path(path):
    """A port path without its layer indices: the reference's path."""
    return tuple(k for k in path if not isinstance(k, int))


# -- the six cases of tests/test_distribution.py -----------------------------
def test_param_rules_gemma(mesh16):
    """8 q-heads can't shard over model=16 → attention replicated on tp;
    FFN (16384) and vocab (256000) shard."""
    cfg = get_config("gemma-2b")
    specs, report = shd.param_specs(cfg, build_model(cfg).param_shapes(),
                                    mesh16, mode="serve")
    assert specs["embed"] == P("model", None)
    assert specs["layers"][0]["mlp"]["w_gate"] == P(None, "model")
    assert specs["layers"][0]["attn"]["wq"] == P(None, None)
    assert any("wq" in p for p in report.replicated)


def test_param_rules_qwen_heads_shard(mesh16):
    cfg = get_config("qwen3-1.7b")
    specs, _ = shd.param_specs(cfg, build_model(cfg).param_shapes(), mesh16,
                               mode="serve")
    attn = specs["layers"][5]["attn"]
    assert attn["wq"] == P(None, "model")
    assert attn["wk"] == P(None, None)           # kv heads = 8 -> replicated
    assert attn["wo"] == P("model", None)


def test_param_rules_moe_expert_parallel(mesh16):
    cfg = get_config("deepseek-moe-16b")
    specs, _ = shd.param_specs(cfg, build_model(cfg).param_shapes(), mesh16,
                               mode="serve")
    assert specs["layers"][0]["moe"]["w_gate"] == P("model", None, None)


def test_fsdp_only_in_train(mesh16):
    cfg = get_config("qwen3-1.7b")
    shapes = build_model(cfg).param_shapes()
    tr, _ = shd.param_specs(cfg, shapes, mesh16, mode="train")
    sv, _ = shd.param_specs(cfg, shapes, mesh16, mode="serve")
    assert "data" in str(tr["layers"][0]["attn"]["wk"])
    assert "data" not in str(sv["layers"][0]["attn"]["wk"])
    no, _ = shd.param_specs(cfg, shapes, mesh16, mode="train", no_fsdp=True)
    assert "data" not in str(no["layers"][0]["attn"]["wk"])


def test_cache_specs_policies(mesh16):
    cfg = get_config("qwen3-1.7b")
    api = build_model(cfg)
    # decode_32k-like: B=128 shardable, kv heads 8 NOT divisible by 16
    k = shd.cache_specs(cfg, api.cache_shapes(128, 32768), mesh16)[
        "layers"]["k"]
    assert k[1] in ("data", ("data",))           # batch over data
    assert k[2] == "model"                       # sequence over model
    # B=1 long-context: batch unshardable -> seq over (model, data)
    k1 = shd.cache_specs(cfg, api.cache_shapes(1, 524288), mesh16)[
        "layers"]["k"]
    assert k1[2] == ("model", "data")


def test_cache_specs_heads_shard(mesh16):
    cfg = get_config("zamba2-1.2b")              # kv=32 divisible
    specs = shd.cache_specs(cfg, build_model(cfg).cache_shapes(128, 32768),
                            mesh16)
    assert specs["attn_k"][-2] == "model"


# -- every leaf, every config, both meshes, both modes ---------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference_on_production_meshes(arch, mode,
                                                          mesh_name):
    rmesh, pmesh = meshes(mesh_name)
    rcfg, pcfg = r_get_config(arch), get_config(arch)
    rshapes = r_build_model(rcfg).param_shapes()
    want, rreport = rshd.param_specs(rcfg, rshapes, rmesh, mode=mode)
    got, preport = shd.param_specs(pcfg, build_model(pcfg).param_shapes(),
                                   pmesh, mode=mode)
    n = 0
    for path, spec in leaves(got):
        rpath = ref_path(path)
        rshape = at(rshapes, rpath)
        wspec = norm(at(want, rpath))
        nstack = len(rshape) - len(spec)
        assert all(e is None for e in wspec[:nstack]), (path, wspec)
        assert norm(spec) == wspec[nstack:], (path, spec, wspec)
        n += 1
    assert n > 0
    for field in ("tp_sharded", "fsdp_sharded", "replicated"):
        ported = {"/".join(p for p in name.split("/") if not p.isdigit())
                  for name in getattr(preport, field)}
        assert ported == set(getattr(rreport, field)), field


def _cache_case(arch, shape_name, mesh_name, seq_shard=False):
    rmesh, pmesh = meshes(mesh_name)
    rshape, pshape = R_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    rcfg = r_arch_shape_cfg(r_get_config(arch), rshape)
    pcfg = arch_shape_cfg(get_config(arch), pshape)
    assert (rcfg is None) == (pcfg is None)
    if rcfg is None:
        return 0
    rc = r_build_model(rcfg).cache_shapes(rshape.global_batch,
                                          rshape.seq_len)
    pc = build_model(pcfg).cache_shapes(pshape.global_batch, pshape.seq_len)
    want = rshd.cache_specs(rcfg, rc, rmesh, seq_shard=seq_shard)
    got = shd.cache_specs(pcfg, pc, pmesh, seq_shard=seq_shard)
    n = 0
    for path, spec in leaves(got):
        wspec = norm(at(want, path))
        drop = len(wspec) - len(spec)        # the hybrid's [G, K] → [L]
        assert all(e is None for e in wspec[:drop])
        assert norm(spec) == wspec[drop:], (path, spec, wspec)
        n += 1
    bwant = rshd.batch_specs(rcfg, {k: v.shape for k, v in
                                    r_batch_input_specs(rcfg,
                                                        rshape).items()},
                             rmesh)
    bgot = shd.batch_specs(pcfg, batch_input_specs(pcfg, pshape), pmesh)
    assert {k: norm(v) for k, v in bgot.items()} == \
        {k: norm(v) for k, v in bwant.items()}
    return n


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_cache_and_batch_specs_match_reference(shape_name, mesh_name):
    assert sum(_cache_case(arch, shape_name, mesh_name)
               for arch in ARCH_NAMES) > 0


def test_sequence_sharded_cache_matches_reference():
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b", "zamba2-1.2b"):
        assert _cache_case(arch, "decode_32k", "16x16", seq_shard=True) > 0


@pytest.mark.parametrize("lever", ["REPRO_ROWPAR_ATTN", "REPRO_NO_FSDP"])
def test_env_levers_match_reference(lever, monkeypatch):
    monkeypatch.setenv(lever, "1")
    rmesh, pmesh = meshes("16x16")
    rcfg, pcfg = r_get_config("gemma-2b"), get_config("gemma-2b")
    rshapes = r_build_model(rcfg).param_shapes()
    want, rreport = rshd.param_specs(rcfg, rshapes, rmesh, mode="train")
    got, preport = shd.param_specs(pcfg, build_model(pcfg).param_shapes(),
                                   pmesh, mode="train")
    for name in ("wq", "wk", "wv", "wo"):
        w = norm(want["layers"]["attn"][name])
        assert norm(got["layers"][3]["attn"][name]) == w[1:]
    if lever == "REPRO_ROWPAR_ATTN":
        # gemma's 8 q-heads on 16: the contraction dim on "model" instead
        assert got["layers"][0]["attn"]["wq"][0] == "model"
        assert any("(rowpar)" in p for p in preport.tp_sharded)
    else:
        assert not preport.fsdp_sharded and not rreport.fsdp_sharded


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_estimate_matches_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        want = r_model_flops(r_get_config(arch), R_SHAPES[name])
        got = model_flops_estimate(get_config(arch), shape)
        np.testing.assert_allclose(got, want, rtol=1e-12)
