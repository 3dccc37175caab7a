"""Decision-throughput benchmark of the port: scalar oracles against the
vectorised core, the counterpart of ``benchmarks/bench_decisions.py``.

Three modes, as there:

  * default      — ``optimal_split`` (O(L²) scalar oracle vs O(L)), the
                   environment sweep (per-env scalar loop vs one
                   ``sweep_links``), Q-learning training, and the
                   ``min_min``/``max_min``/``heft`` ETC heuristics;
  * ``--cost``   — decisions/s of ``decide_all`` per cost model over a
                   1024-environment link grid; the predictor sweep must be
                   ONE vectorised ``predict`` call (on the kernel path: one
                   ``tree_predict`` launch);
  * ``--backend`` — ``decide_all`` per path over the BENCH_3 grid, L 64 /
                   1024 x E 1,024 / 16,384.

Paths (``bench.common.paths``): the CPU rows run the port's plain path on
``device="cpu"`` (``backend="torch"``, the exact f64 sweep) and carry
``plain: true``; on the card the same sweep runs again (``card`` rows) and
through the ``decide_split`` kernel (``kernel`` rows, with their
launches).  In ``--backend`` mode the rows keep the reference's names:
its ``numpy`` rows are the CPU's, ``jax`` the card's ``torch`` sweep,
``pallas`` the kernel's (``port_backend`` says which ran).  Elsewhere the
card's rows are the reference's names with ``_card`` / ``_kernel``
appended.  The scalar oracles, Q-learning and the ETC heuristics are host
numpy code in the port as in the reference: CPU rows only.

Gates: the predictor sweep's single predict call; at 16,384 envs the
card's ``torch`` and ``kernel`` sweeps no slower than the CPU's ``torch``
one (best of reps, 5% allowance), as the reference holds jit against
numpy.

Run:  PYTHONPATH=src python -m repro_torch.bench.decisions [--device cpu] \\
          [--smoke] [--cost all | --backend all]

Rows go to ``results/bench_torch_decisions{,_cost,_backend}.json``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bench.common import (counting, emit, parser, paths,
                                      require, tag, times_us)
from repro_torch.core import costs as co
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.core import scheduler as sch
from repro_torch.hw import EDGE_DEVICES, get_device

#: the rows' timing fields; every other field is compared with the
#: reference's rows
TIMED = ("us_per_call", "us_scalar", "speedup", "decisions_per_s",
         "episodes_per_s", "schedules_per_s", "best_us",
         "speedup_vs_numpy")
BACKEND_OF = {"cpu": "numpy", "card": "jax", "kernel": "pallas"}


def wall_us(fn, *args, reps: int = 5) -> float:
    """Median wall-clock per call in microseconds."""
    return times_us(lambda: fn(*args), reps)[0]


def synth_layers(L: int, seed: int = 0) -> list[off.LayerCost]:
    rng = np.random.default_rng(seed)
    return [off.LayerCost(f"l{i}",
                          flops=float(rng.uniform(1e8, 1e11)),
                          act_bytes=float(rng.uniform(1e3, 1e7)))
            for i in range(L)]


def make_env(link_bw: float = 0.125e9) -> off.OffloadEnv:
    return off.OffloadEnv(device=get_device("pi5-arm"),
                          edge=get_device("edge-server-a100"),
                          link_bw=link_bw, input_bytes=1e5)


def qtrain_scalar_ref(layers, env, episodes: int, seed: int = 0):
    """Replica of the seed's per-episode scalar Q-learning loop."""
    buckets = (0.125e9 / 16, 0.125e9 / 4, 0.125e9, 1.25e9)
    n_actions = len(layers) + 1
    q = np.zeros((len(buckets), n_actions))
    rng = np.random.default_rng(seed)
    for _ in range(episodes):
        s = int(rng.integers(len(buckets)))
        if rng.random() < 0.2:
            a = int(rng.integers(n_actions))
        else:
            a = int(np.argmax(q[s]))
        e = dataclasses.replace(env, link_bw=buckets[s])
        q[s, a] += 0.2 * (-off.split_time(layers, a, e).total_time_s
                          - q[s, a])
    return q


class _CountingModel:
    """Regressor proxy counting ``predict`` calls (vectorisation proof)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def predict(self, x, **kw):
        self.calls += 1
        return self.inner.predict(x, **kw)


def _fit_profiling_gbt(layers, dev):
    """Small GBT over (layer, hardware) features → analytic layer times,
    standing in for the paper's trained profiling model; fitted on
    ``dev``."""
    from repro_torch.core.predictors import GBTRegressor
    feats, ys = [], []
    for spec in EDGE_DEVICES.values():
        feats.append(co.default_layer_features(layers, spec))
        ys.append([off.layer_time(lc.flops, spec) for lc in layers])
    return GBTRegressor(n_trees=40, max_depth=4).fit(
        np.concatenate(feats), np.concatenate(ys), device=dev)


def _suffix(name: str, path: str) -> str:
    return name if path == "cpu" else f"{name}_{path}"


def cost_rows(which: str, path: str, dev, smoke: bool = False
              ) -> list[dict]:
    """decisions/s of ``decide_all`` per cost model over a 1024-env link
    sweep on one path."""
    reps = 3 if smoke else 7
    n_envs = 1024                       # ≥1024: the fleet-sweep guarantee
    layers = synth_layers(64)
    device, edge = get_device("pi5-arm"), get_device("edge-server-a100")
    backend = "kernel" if path == "kernel" else "torch"
    # two link-state grids, alternated per call: every sweep sees fresh
    # envs, so per-(layers, envs) memoisation inside the cost models cannot
    # flatter the numbers; only the per-layer predict memo persists
    env_grids = [dec.make_envs(device, edge,
                               link_bw=np.geomspace(1e5, 1e10, n_envs) * f,
                               input_bytes=1e5, device=dev)
                 for f in (1.0, 1.1)]
    calls = {"n": 0}

    def sweep(cost):
        calls["n"] += 1
        return dec.decide_all(layers, env_grids[calls["n"] % 2], cost=cost,
                              backend=backend, device=dev)

    selected, counter = {}, None
    if which in ("analytic", "all"):
        selected["analytic"] = co.AnalyticCost()
    if which in ("predictor", "all"):
        gbt = _fit_profiling_gbt(layers, dev)
        # the kernel path lowers the fitted trees themselves
        counter = gbt if path == "kernel" else _CountingModel(gbt)
        selected["predictor"] = co.PredictorCost(counter, device, edge)
    if which in ("composite", "all"):
        selected["composite"] = co.CompositeCost(
            weights={"latency_s": 1.0, "energy_j": 0.05, "price": 1.0},
            price_per_edge_s=0.1, price_per_gb=0.01, deadline_s=0.05)
    rows = []
    for name, cost in selected.items():
        if isinstance(counter, _CountingModel):
            counter.calls = 0
        with counting() as launched:
            t = wall_us(lambda: sweep(cost), reps=reps)
        row = {
            "name": _suffix(f"cost_{name}_sweep{n_envs}", path),
            "us_per_call": t,
            "decisions_per_s": n_envs * 1e6 / t,
            "n_objectives": len(cost.objectives),
        }
        if name == "predictor":
            # memoised on the layer set: every repeated sweep shares ONE
            # vectorised predict call, no per-env Python loop
            n = launched.get("tree_predict", 0) if path == "kernel" \
                else counter.calls
            require(n == 1, f"predictor sweep must be ONE vectorised "
                    f"predict call, got {n} over {reps + 1} sweeps "
                    f"({path})")
            row["predict_calls"] = n
        kernels = ("decide_split", "tree_predict") if name == "predictor" \
            else ("decide_split",)
        rows.append(tag(row, path, launched, kernels))
    return rows


def main_costs(which: str, smoke: bool = False, device=None) -> list[dict]:
    """decisions/s of ``decide_all`` per cost model, 1024-env link sweep,
    on every path of the invocation."""
    rows = []
    for path, dev in paths(device):
        rows += cost_rows(which, path, dev, smoke)
    emit(rows, "decisions_cost")
    return rows


def backend_rows(cells, reps: int, runs) -> list[dict]:
    """``decide_all`` per path over ``cells`` of ``(L, n_envs)``; ``runs``
    are ``(path, torch device)``.  At 16,384 envs the card's paths must
    not be slower than the CPU's (best of reps, 5% allowance)."""
    device, edge = get_device("pi5-arm"), get_device("edge-server-a100")
    rows = []
    for L, n_envs in cells:
        layers = synth_layers(L)
        cell = {}
        for path, dev in runs:
            backend = "kernel" if path == "kernel" else "torch"
            envs = dec.make_envs(device, edge,
                                 link_bw=np.geomspace(1e5, 1e10, n_envs),
                                 input_bytes=1e5, device=dev)
            with counting() as launched:
                t, best = times_us(lambda: dec.decide_all(
                    layers, envs, backend=backend, device=dev), reps)
            ref = BACKEND_OF[path]
            cell[ref] = best
            row = {
                "name": f"decide_{ref}_L{L}_envs{n_envs}",
                "backend": ref,
                "port_backend": backend,
                "n_envs": n_envs,
                "n_layers": L,
                "us_per_call": t,
                "best_us": best,
                "decisions_per_s": n_envs * 1e6 / t,
            }
            if path != "cpu" and "numpy" in cell:
                row["speedup_vs_numpy"] = cell["numpy"] / best
            rows.append(tag(row, path, launched, ("decide_split",)))
        if n_envs == 16384:
            # best-of-reps (true speed) with a 5% allowance, as the
            # reference compares its jit path with numpy
            for ref in ("jax", "pallas"):
                if ref in cell and "numpy" in cell:
                    require(cell[ref] <= cell["numpy"] * 1.05, (
                        f"decide_all on the card ({ref} row) slower than "
                        f"the CPU at the fleet size: best {cell[ref]:.0f}us "
                        f"vs {cell['numpy']:.0f}us (L={L}, n_envs={n_envs})"))
    return rows


def main_backends(which: str, smoke: bool = False, device=None
                  ) -> list[dict]:
    """``decide_all`` per path over the (L, n_envs) grid of BENCH_3;
    ``which`` names the reference's backend (``numpy`` = the CPU, ``jax``
    = the card's torch sweep, ``pallas`` = the kernel) or ``all``."""
    want = ("numpy", "jax", "pallas") if which == "all" else (which,)
    runs = [(p, d) for p, d in paths(device) if BACKEND_OF[p] in want]
    cells = [(64, 1024), (64, 16384)] if smoke \
        else [(64, 1024), (64, 16384), (1024, 1024), (1024, 16384)]
    rows = backend_rows(cells, 4 if smoke else 7, runs)
    emit(rows, "decisions_backend")
    return rows


def split_rows(depths, reps: int) -> list[dict]:
    """All-splits offloading, varying depth (host code)."""
    env = make_env()
    rows = []
    for L in depths:
        layers = synth_layers(L)
        t_ref = wall_us(off.optimal_split_ref, layers, env, reps=reps)
        t_vec = wall_us(off.optimal_split, layers, env, reps=reps)
        rows.append(tag({
            "name": f"optimal_split_L{L}",
            "us_per_call": t_vec,
            "us_scalar": t_ref,
            "speedup": t_ref / t_vec,
            "decisions_per_s": 1e6 / t_vec,
        }, "cpu"))
    return rows


def env_sweep_rows(sizes, reps: int, runs) -> list[dict]:
    """The batched environment sweep against the per-env scalar loop, on
    each path of ``runs``."""
    env = make_env()
    layers = synth_layers(64)
    rows = []
    for n_envs in sizes:
        bws = np.geomspace(1e5, 1e10, n_envs)

        def sweep_scalar():
            return [off.optimal_split_ref(layers,
                                          dataclasses.replace(env,
                                                              link_bw=b))
                    for b in bws]

        t_ref = wall_us(sweep_scalar, reps=min(reps, 3))
        for path, dev in runs:
            backend = "kernel" if path == "kernel" else "torch"
            with counting() as launched:
                t_vec = wall_us(lambda: dec.sweep_links(
                    layers, env, bws, backend=backend, device=dev),
                    reps=reps)
            rows.append(tag({
                "name": _suffix(f"env_sweep_{n_envs}", path),
                "us_per_call": t_vec,
                "us_scalar": t_ref,
                "speedup": t_ref / t_vec,
                "decisions_per_s": n_envs * 1e6 / t_vec,
            }, path, launched, ("decide_split",)))
    return rows


def qlearning_rows(episodes: int, reps: int) -> list[dict]:
    """Q-learning training: the scalar loop against the table-driven
    trainer (host code)."""
    env = make_env()
    layers_q = synth_layers(12)
    t_ref = wall_us(qtrain_scalar_ref, layers_q, env, episodes, reps=reps)
    t_vec = wall_us(
        lambda: off.QLearningPolicy(layers_q, env,
                                    episodes=episodes).train(), reps=reps)
    return [tag({
        "name": f"qlearning_train_{episodes}ep",
        "us_per_call": t_vec,
        "us_scalar": t_ref,
        "speedup": t_ref / t_vec,
        "episodes_per_s": episodes * 1e6 / t_vec,
    }, "cpu")]


def etc_rows(shapes, reps: int) -> list[dict]:
    """The ETC schedulers, nested loops against masked-matrix argmins
    (host code)."""
    rows = []
    for n_tasks, n_nodes in shapes:
        rng = np.random.default_rng(n_tasks)
        specs = list(EDGE_DEVICES.values())
        nodes = [sch.Node(specs[j % len(specs)]) for j in range(n_nodes)]
        tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                          input_bytes=float(rng.uniform(1e4, 1e7)))
                 for i in range(n_tasks)]
        etc = sch.etc_matrix(tasks, nodes)
        for name in ("min_min", "max_min", "heft"):
            t_ref = wall_us(sch.SCHEDULERS_REF[name], tasks, nodes, etc,
                            reps=reps)
            t_vec = wall_us(sch.SCHEDULERS[name], tasks, nodes, etc,
                            reps=reps)
            rows.append(tag({
                "name": f"{name}_{n_tasks}x{n_nodes}",
                "us_per_call": t_vec,
                "us_scalar": t_ref,
                "speedup": t_ref / t_vec,
                "schedules_per_s": 1e6 / t_vec,
            }, "cpu"))
    return rows


def main(smoke: bool = False, device=None) -> list[dict]:
    reps = 2 if smoke else 7
    rows = split_rows((16, 64) if smoke else (16, 64, 256, 1024), reps)
    rows += env_sweep_rows((256,) if smoke else (256, 1024), reps,
                           paths(device))
    rows += qlearning_rows(300 if smoke else 3000, reps)
    rows += etc_rows([(100, 16)] if smoke
                     else [(40, 5), (100, 16), (400, 32)], reps)
    emit(rows, "decisions")
    return rows


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--cost", choices=("analytic", "predictor", "composite",
                                       "all"),
                    help="run the cost-model sweep mode instead")
    ap.add_argument("--backend", choices=("numpy", "jax", "pallas", "all"),
                    help="run the decision-backend sweep mode instead "
                    "(numpy = the CPU, jax = the card's torch sweep, "
                    "pallas = the kernel)")
    args = ap.parse_args()
    if args.cost:
        main_costs(args.cost, smoke=args.smoke, device=args.device)
    elif args.backend:
        main_backends(args.backend, smoke=args.smoke, device=args.device)
    else:
        main(smoke=args.smoke, device=args.device)
