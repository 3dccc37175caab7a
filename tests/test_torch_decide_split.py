"""The port's decision core against the JAX package's.

* Bit for bit (f64): latency and transfer matrices, every cost model's
  components and scalarisation, and ``decide_all(backend="torch")`` plans
  equal the reference's numpy host path exactly.
* f32: the plain twin of the ``decide_split`` kernel against the
  reference Pallas kernel in interpret mode on the same packed inputs —
  splits equal on these seeds, costs within ``rtol=1e-5``.
* Re-costing: ``decide_all(backend="kernel")`` picks splits within the
  near-optimality bound of ``tests/test_decide_split.py`` and re-costs them
  consistently in f64.
* Degenerate shapes: L = 0, E = 0, L = 300 (several split blocks) and E not
  a multiple of the Pallas env block.
* The CUDA kernel's regrouped, division-free f32 arithmetic in plain
  PyTorch: within ``rtol=1e-5`` of the plain twin, near-optimal in f64, and
  the first of tied splits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.kernels.decide_split import kernel as rkernel
from repro.kernels.decide_split.ref import decide_ref, latency_matrix_ref
from repro.sim.queueing import ServerPool, WeibullRTT

from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.kernels.decide_split import kernel as pkernel
from repro_torch.kernels.decide_split import ops as pops
from repro_torch.kernels.decide_split import ref as ds_ref
from repro_torch.kernels.decide_split.ref import decide_split_ref

CPU = "cpu"
PLAN_FIELDS = ("splits", "total_time_s", "device_time_s",
               "transfer_time_s", "edge_time_s")
COSTS = ("analytic", "composite", "queue", "queue_latency", "p99", "cvar",
         "queue_p99")


def np_(t):
    return None if t is None else t.cpu().numpy()


def make_case(seed, n_layers, n_envs):
    """The same random layers and environments for both packages."""
    rng = np.random.default_rng(seed)
    flops = rng.uniform(1e6, 1e12, n_layers)
    act = rng.uniform(1e2, 1e8, n_layers)
    names = list(R_DEVICES)
    dev = [names[i] for i in rng.integers(len(names), size=n_envs)]
    edge = names[int(rng.integers(len(names)))]
    bw = rng.uniform(1e4, 1e10, n_envs)
    lat = rng.uniform(0.0, 0.05, n_envs)
    inp = rng.uniform(0.0, 1e7, n_envs)
    ref = ([roff.LayerCost(f"l{i}", flops=float(f), act_bytes=float(a))
            for i, (f, a) in enumerate(zip(flops, act))],
           rdec.make_envs([R_DEVICES[d] for d in dev], R_DEVICES[edge],
                          link_bw=bw, link_latency_s=lat, input_bytes=inp))
    port = ([poff.LayerCost(f"l{i}", flops=float(f), act_bytes=float(a))
             for i, (f, a) in enumerate(zip(flops, act))],
            pdec.make_envs([P_DEVICES[d] for d in dev], P_DEVICES[edge],
                           link_bw=bw, link_latency_s=lat,
                           input_bytes=inp, device=CPU))
    return ref, port


def cost_pair(kind):
    """(reference cost model, port cost model) of one kind; the tail and
    queue objectives share one RTT / pool object between the two."""
    if kind is None:
        return None, None
    if kind == "analytic":
        return rco.AnalyticCost(0.3), pco.AnalyticCost(0.3)
    kw = dict(weights={"latency_s": 1.0, "energy_j": 0.05, "price": 1.0},
              price_per_edge_s=0.1, price_per_gb=0.01, deadline_s=0.05)
    if kind in ("p99", "cvar", "queue_p99"):
        rtt = WeibullRTT(shape=0.7, scale=0.02, seed=0)
        kw = dict(kw, tail="cvar" if kind == "cvar" else "p99",
                  tail_alpha=0.95, rtt=rtt,
                  weights={**kw["weights"], "tail_latency_s": 0.5})
    ref, port = rco.CompositeCost(**kw), pco.CompositeCost(**kw)
    if kind == "queue_latency":
        ref, port = rco.AnalyticCost(), pco.AnalyticCost()
    if kind.startswith("queue"):
        pool = ServerPool(1)
        pool.admit(0.0, 0.03)                    # busy: a live wait
        ref = rco.QueueAwareCost(base=ref, edge_pool=pool, wait_s=0.01)
        port = pco.QueueAwareCost(base=port, edge_pool=pool, wait_s=0.01)
        ref.set_now(0.01)
        port.set_now(0.01)
    return ref, port


def assert_plans_equal(ref, got):
    for f in PLAN_FIELDS:
        assert np.array_equal(getattr(ref, f), np_(getattr(got, f))), f
    assert ref.objectives == got.objectives
    for f in ("components", "scalar_cost"):
        x, y = getattr(ref, f), np_(getattr(got, f))
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f


# --------------------------------------------------------------------------
# Bit for bit in f64
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n_layers,n_envs",
                         [(0, 12, 37), (1, 1, 5), (2, 0, 4), (3, 40, 9)])
def test_latency_and_transfer_matrices_bit_for_bit(seed, n_layers, n_envs):
    (rl, re), (pl, pe) = make_case(seed, n_layers, n_envs)
    assert np.array_equal(latency_matrix_ref(rl, re),
                          np_(pdec.latency_matrix(pl, pe)))
    assert np.array_equal(rdec.latency_matrix(rl, re, 0.2),
                          np_(pdec.latency_matrix(pl, pe, 0.2)))
    assert np.array_equal(rdec.transfer_matrix(rl, re),
                          np_(pdec.transfer_matrix(pl, pe)))
    assert np.array_equal(rdec.transfer_bytes(rl, re),
                          np_(pdec.transfer_bytes(pl, pe)))


@pytest.mark.parametrize("kind", COSTS)
def test_cost_components_and_scalarisation_bit_for_bit(kind):
    (rl, re), (pl, pe) = make_case(7, 10, 23)
    rc, pc = cost_pair(kind)
    rcomp = np.asarray(rc.components(rl, re))
    pcomp = pc.components(pl, pe)
    assert np.array_equal(rcomp, np_(pcomp))
    assert np.array_equal(rc.scalarize(rcomp), np_(pc.scalarize(pcomp)))
    for r, p in zip(rc.latency_parts(rl, re), pc.latency_parts(pl, pe)):
        assert np.array_equal(np.asarray(r), np_(p))


@pytest.mark.parametrize("kind", (None,) + COSTS)
@pytest.mark.parametrize("seed,n_layers,n_envs",
                         [(11, 16, 64), (12, 0, 3), (13, 300, 19),
                          (14, 5, 0)])
def test_decide_all_torch_bit_for_bit(kind, seed, n_layers, n_envs):
    (rl, re), (pl, pe) = make_case(seed, n_layers, n_envs)
    rc, pc = cost_pair(kind)
    assert_plans_equal(rdec.decide_all(rl, re, cost=rc, backend="numpy"),
                       pdec.decide_all(pl, pe, cost=pc, backend="torch",
                                       device=CPU))


def test_sweep_links_and_replan_bit_for_bit():
    rng = np.random.default_rng(6)
    flops, act = rng.uniform(1e6, 1e12, 8), rng.uniform(1e2, 1e8, 8)
    rl = [roff.LayerCost(f"l{i}", float(f), float(a))
          for i, (f, a) in enumerate(zip(flops, act))]
    pl = [poff.LayerCost(f"l{i}", float(f), float(a))
          for i, (f, a) in enumerate(zip(flops, act))]
    bws = np.geomspace(1e5, 1e9, 16)
    renv = roff.OffloadEnv(R_DEVICES["pi5-arm"],
                           R_DEVICES["edge-server-a100"], link_bw=1e8,
                           input_bytes=1e5)
    penv = poff.OffloadEnv(P_DEVICES["pi5-arm"],
                           P_DEVICES["edge-server-a100"], link_bw=1e8,
                           input_bytes=1e5)
    ref = rdec.sweep_links(rl, renv, bws)
    got = pdec.sweep_links(pl, penv, bws, backend="torch", device=CPU)
    assert_plans_equal(ref, got)
    (rl, re), (pl, pe) = make_case(8, 9, 30)
    rc, pc = cost_pair("composite")
    rprev = rdec.decide_all(rl, re, cost=rc)
    pprev = pdec.decide_all(pl, pe, cost=pc, backend="torch", device=CPU)
    changed = np.zeros(30, bool)
    changed[[1, 4, 29]] = True
    assert_plans_equal(
        rdec.replan(rl, re, rprev, changed, cost=rc),
        pdec.replan(pl, pe, pprev, changed, cost=pc, backend="torch",
                    device=CPU))


# --------------------------------------------------------------------------
# The plain f32 twin against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------
SPECS = {
    "latency": dict(weights=(1.0, 0.0, 0.0, 0.0)),
    "composite": dict(weights=(1.0, 0.05, 1.0, 0.0), radio_watts=2.5,
                      price_per_edge_s=0.1, price_per_gb=0.01,
                      deadline_s=0.05),
    "queue_tail": dict(weights=(1.0, 0.05, 1.0, 2.0), radio_watts=2.5,
                       price_per_edge_s=0.1, price_per_gb=0.01,
                       deadline_s=0.05, queue_wait_s=0.02,
                       tail_excess_s=0.03, tail_weight=0.5),
}


def packed_inputs(seed, n_layers, n_envs):
    rng = np.random.default_rng(seed)
    dcum = np.concatenate(([0.0], np.cumsum(rng.uniform(1e8, 1e11,
                                                        n_layers))))
    ecum = dcum.copy()
    bvec = np.concatenate(([0.0], rng.uniform(1e2, 1e8, n_layers)))
    bvec[-1] = 0.0
    cols = [rng.uniform(1e9, 1e13, n_envs), rng.uniform(1e11, 1e14, n_envs),
            rng.uniform(1e4, 1e10, n_envs), rng.uniform(0.0, 0.05, n_envs),
            rng.uniform(0.0, 1e7, n_envs), rng.uniform(5, 50, n_envs),
            rng.uniform(100, 400, n_envs)]
    return [np.asarray(a, np.float32) for a in (dcum, ecum, bvec, *cols)], \
        float(ecum[-1])


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("seed,n_layers,n_envs",
                         [(0, 28, 64), (1, 0, 5), (2, 300, 37), (3, 7, 1)])
def test_plain_twin_matches_pallas_interpret(spec_name, seed, n_layers,
                                             n_envs):
    arrs, etot = packed_inputs(seed, n_layers, n_envs)
    spec = rkernel.pack_spec(edge_total=etot, **SPECS[spec_name])
    assert np.array_equal(spec, pkernel.pack_spec(edge_total=etot,
                                                  **SPECS[spec_name]))
    rs, rc = rkernel.decide_split_kernel(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(spec), interpret=True)
    ps, pc = pops.decide_split(*(torch.as_tensor(a) for a in arrs),
                               torch.as_tensor(spec))
    assert ps.dtype == torch.int32 and pc.dtype == torch.float32
    assert np.array_equal(np.asarray(rs), ps.numpy())
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-5)


def test_plain_twin_is_the_cpu_dispatch_and_keeps_first_index_on_ties():
    # every split costs the same -> np.argmin semantics pick split 0
    arrs = [torch.zeros(4), torch.zeros(4), torch.zeros(4)] + \
        [torch.ones(3)] * 3 + [torch.zeros(3)] * 4
    spec = torch.as_tensor(pkernel.pack_spec((1.0, 0.0, 0.0, 0.0)))
    s, c = decide_split_ref(*arrs, spec)
    assert s.tolist() == [0, 0, 0] and c.tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.decide_split_kernel(*arrs, spec)


# --------------------------------------------------------------------------
# The CUDA kernel's regrouped arithmetic (no division per split), in plain
# PyTorch: ref.decide_split_factored_ref
# --------------------------------------------------------------------------
FACTORED_SPECS = {
    **SPECS,
    # every weight 0: every split costs 0, the first one is taken
    "zero": dict(weights=(0.0, 0.0, 0.0, 0.0)),
    # the deadline alone, active: the slack path of the kernel
    "deadline": dict(weights=(0.0, 0.0, 0.0, 1.0), deadline_s=0.05),
}


@pytest.mark.parametrize("spec_name", sorted(FACTORED_SPECS))
@pytest.mark.parametrize("seed,n_layers,n_envs",
                         [(0, 28, 64), (1, 0, 5), (2, 300, 37), (3, 7, 1),
                          (4, 28, 4099)])
def test_factored_arithmetic_matches_plain_and_is_near_optimal(
        spec_name, seed, n_layers, n_envs):
    """Costs within the kernel's rtol 1e-5 of the plain version; each
    chosen split within (1 + 1e-4) f64 optimum + 1e-12 of the f64 costs of
    the same f32 inputs (links of 1e4 to 1e10 B/s)."""
    arrs, etot = packed_inputs(seed, n_layers, n_envs)
    args = [torch.as_tensor(a) for a in arrs] + [torch.as_tensor(
        pkernel.pack_spec(edge_total=etot, **FACTORED_SPECS[spec_name]))]
    ps, pc = decide_split_ref(*args)
    fs, fc = ds_ref.decide_split_factored_ref(*args)
    assert fs.dtype == torch.int32 and fc.dtype == torch.float32
    torch.testing.assert_close(fc, pc, rtol=1e-5, atol=0.0)
    exact = ds_ref.cost_matrix_ref(*(a.double() for a in args))
    got = exact.gather(1, fs.long()[:, None])[:, 0]
    assert torch.all(got <= exact.min(dim=1).values * (1 + 1e-4) + 1e-12)
    if spec_name == "zero":
        assert not fs.any()


def test_factored_arithmetic_keeps_the_first_of_tied_splits():
    """Splits 3 and 7 (and 100 and 290, across the kernel's 256-split
    chunks) cost exactly the same least cost: the first is taken."""
    for first, second, n_splits in ((3, 7, 9), (100, 290, 301)):
        dcum = torch.full((n_splits,), 5e9)
        dcum[[first, second]] = 1e9
        bvec = torch.full((n_splits,), 1e3)
        ecum = torch.full((n_splits,), 1e10)
        cols = [torch.full((4,), v) for v in
                (1e10, 1e12, 1e6, 0.01, 1e3, 10.0, 300.0)]
        spec = torch.as_tensor(pkernel.pack_spec(
            (1.0, 0.05, 0.0, 0.0), radio_watts=2.0, edge_total=1e10))
        for fn in (decide_split_ref, ds_ref.decide_split_factored_ref):
            s, _ = fn(dcum, ecum, bvec, *cols, spec)
            assert s.tolist() == [first] * 4


# --------------------------------------------------------------------------
# backend="kernel": near-optimal splits, consistent f64 re-costing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", (None,) + COSTS)
@pytest.mark.parametrize("seed,n_layers,n_envs",
                         [(20, 24, 61), (21, 0, 5), (22, 300, 13),
                          (23, 4, 0)])
def test_decide_all_kernel_near_optimal(kind, seed, n_layers, n_envs):
    (rl, re), (pl, pe) = make_case(seed, n_layers, n_envs)
    rc, pc = cost_pair(kind)
    ref = decide_ref(rl, re, cost=rc)
    got = pdec.decide_all(pl, pe, cost=pc, device=CPU)
    assert got.objectives == ref.objectives
    ranked_ref = ref.scalar_cost if ref.scalar_cost is not None \
        else ref.total_time_s
    ranked_got = np_(got.scalar_cost if got.scalar_cost is not None
                     else got.total_time_s)
    assert ranked_got.shape == (n_envs,)
    assert np.all(ranked_got <= ranked_ref * (1 + 1e-4) + 1e-12)
    # the plan's own breakdown is internally consistent
    np.testing.assert_allclose(
        np_(got.device_time_s + got.transfer_time_s + got.edge_time_s),
        np_(got.total_time_s), rtol=1e-9, atol=1e-15)
    # on these seeds the argmin agrees outright
    assert np.array_equal(ref.splits, np_(got.splits))
    for f in PLAN_FIELDS[1:]:
        np.testing.assert_allclose(np_(getattr(got, f)), getattr(ref, f),
                                   rtol=1e-5, atol=1e-12, err_msg=f)


def test_kernel_backend_rejects_unlowerable_cost():
    (_, _), (pl, pe) = make_case(0, 3, 2)

    class HostOnly:
        objectives = ("latency_s",)

    with pytest.raises(TypeError, match="backend='torch'"):
        pdec.decide_all(pl, pe, cost=HostOnly(), device=CPU)
    with pytest.raises(ValueError, match="efficiency"):
        pdec.decide_all(pl, pe, 0.2, cost=pco.AnalyticCost(), device=CPU)
