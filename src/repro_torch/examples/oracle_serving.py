"""Oracle serving end to end, on the port: lowered predictor sweeps + the
closed loop.

1. Fit the paper's profiling GBT on (layer, hardware) features
   (``gbt_hist`` on the card).
2. Run a 16384-environment predictor-driven offloading sweep on the
   ``decide_split`` kernel (the fitted trees walked by ``tree_predict``),
   its splits held against the exact f64 sweep.
3. Stream realised execution times through an OnlineOracle while two
   device classes silently slow down 3x: watch the rolling nRMSE
   degrade, the Page-Hinkley detector fire, and a fresh-window refit
   (published to the versioned registry) recover accuracy.
4. Ride the oracle along a streaming simulation — with a static world
   it is bit-transparent: identical placements to the oracle-free path.

Run:  PYTHONPATH=src python -m repro_torch.examples.oracle_serving \
          [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import costs as co
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.core import scheduler as sch
from repro_torch.core.predictors import GBTRegressor
from repro_torch.examples import parser, require
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.oracle import OnlineOracle
from repro_torch.sim import simulate_stream

DEVICE, EDGE = get_device("pi5-arm"), get_device("edge-server-a100")
SPECS = list(EDGE_DEVICES.values())


def fit_profiler(rng, dev, n_layers=256, n_trees=120, max_depth=8):
    layers = [off.LayerCost(f"l{i}", flops=float(f), act_bytes=0.0)
              for i, f in enumerate(rng.uniform(1e8, 1e11, n_layers))]
    x = np.concatenate([co.default_layer_features(layers, s)
                        for s in SPECS])
    y = np.concatenate([[off.layer_time(lc.flops, s) for lc in layers]
                        for s in SPECS])
    return GBTRegressor(n_trees=n_trees, max_depth=max_depth).fit(
        x, y, device=dev)


def sweep(gbt, rng, dev) -> tuple[np.ndarray, np.ndarray, int]:
    """``(kernel splits, exact f64 splits, layers)`` of the 16384-env
    predictor-driven sweep."""
    layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e9)),
                            act_bytes=float(rng.uniform(1e3, 1e5)))
              for i in range(48)]
    envs = dec.make_envs(DEVICE, EDGE,
                         link_bw=np.geomspace(1e4, 1e10, 16384),
                         input_bytes=1e7, device=dev)
    cost = co.PredictorCost(gbt, DEVICE, EDGE)
    exact = dec.decide_all(layers, envs, cost=cost, backend="torch",
                           device=dev)
    kern = dec.decide_all(layers, envs, cost=cost, device=dev)
    return (kern.splits.cpu().numpy(), exact.splits.cpu().numpy(),
            len(layers))


def drift_loop(gbt, rng, dev, steps: int = 700) -> tuple[list, list, int]:
    """``(events, nRMSE track, registry version)``: the drift → detect →
    refit loop; ``events`` holds ``(step, "drift", nRMSE)`` and ``(step,
    "refit", version)`` in order."""
    oracle = OnlineOracle(gbt, DEVICE, EDGE, window=256, min_refit=120,
                          correction="none", torch_device=dev)
    track, events = [], []
    for step in range(steps):
        spec = SPECS[int(rng.integers(len(SPECS)))]
        flops = float(rng.uniform(1e8, 1e11))
        f = oracle.feature_fn(
            [off.LayerCost("q", flops=flops, act_bytes=0.0)], spec)[0]
        t = off.layer_time(flops, spec)
        if step >= 200 and spec.tdp_watts in (12, 15):
            t *= 3.0                 # pi5 + jetson quietly slow down
        out = oracle.observe(f, t)
        track.append(oracle.rolling_nrmse())
        if out["drift"]:
            events.append((step, "drift", track[-1]))
        if out["refit_version"] is not None:
            events.append((step, "refit", out["refit_version"]))
    return events, track, oracle.version


def static_stream(gbt, rng, dev):
    """``(nodes, records equal, summary)``: the oracle riding a static
    stream against the oracle-free path."""
    nodes = [sch.Node(SPECS[j % len(SPECS)]) for j in range(4)]
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e6)))
             for i in range(60)]
    arrivals = np.sort(rng.uniform(0.0, 12.0, len(tasks)))
    plain = simulate_stream(tasks, arrivals, nodes,
                            cost=co.PredictorCost(gbt, DEVICE, EDGE),
                            device=dev)
    riding = OnlineOracle(gbt, DEVICE, EDGE, torch_device=dev)
    with_oracle = simulate_stream(tasks, arrivals, nodes, oracle=riding,
                                  device=dev)
    same = all(a.node == b.node and a.finished_s == b.finished_s
               for a, b in zip(plain.records, with_oracle.records))
    return nodes, same, with_oracle.summary()


def ground_truth(task, spec, etc_s, start_s):
    """pi5 + jetson quietly start running 3x slower a third of the way
    in: the world the predictor does not know."""
    slow = 3.0 if start_s >= 130.0 and spec.tdp_watts in (12, 15) else 1.0
    return slow * off.layer_time(task.flops, spec)


def drifted_stream(gbt, rng, nodes, dev) -> tuple[dict, int]:
    """``(summary, registry version)`` of 400 tasks through the sim loop
    under :func:`ground_truth`."""
    many = [sch.Task(f"d{i}", flops=float(rng.uniform(1e8, 1e11)),
                     input_bytes=0.0) for i in range(400)]
    arr = np.sort(rng.uniform(0.0, 400.0, len(many)))
    learner = OnlineOracle(gbt, DEVICE, EDGE, window=256, min_refit=64,
                           correction="none", torch_device=dev)
    drifted = simulate_stream(many, arr, nodes, oracle=learner,
                              service_time_fn=ground_truth, device=dev)
    return drifted.summary(), learner.version


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    rng = np.random.default_rng(0)
    print("== 1. fit the profiling predictor ==")
    gbt = fit_profiler(rng, dev)

    print("\n== 2. predictor-driven sweep, lowered to the accelerator ==")
    splits, exact, n_layers = sweep(gbt, rng, dev)
    require(np.array_equal(splits, exact),
            "the kernel's splits differ from the exact f64 sweep")
    on_dev = np.bincount(np.minimum(splits, 2), minlength=3)
    print(f"  {len(splits)} envs swept on backend='kernel'; splits exactly "
          f"match torch\n  all-edge: {on_dev[0]}, partial: "
          f"{len(splits) - on_dev[0] - (splits == n_layers).sum()},"
          f" all-device: {(splits == n_layers).sum()}")

    print("\n== 3. online drift -> detection -> refit -> recovery ==")
    events, track, version = drift_loop(gbt, rng, dev)
    for step, kind, value in events:
        if kind == "drift":
            print(f"  step {step:3d}: drift detected "
                  f"(injected at 200), nRMSE {value:.4f}")
        else:
            print(f"  step {step:3d}: refit on fresh window -> "
                  f"registry v{value}")
    print(f"  nRMSE pre-drift {np.mean(track[150:200]):.4f} -> "
          f"peak {max(track[200:]):.4f} -> "
          f"recovered {np.mean(track[-50:]):.4f} "
          f"(registry version {version})")

    print("\n== 4. oracle riding the streaming simulator ==")
    nodes, same, s = static_stream(gbt, rng, dev)
    print(f"  static world: placements identical to oracle-free path: "
          f"{same}")
    print(f"  {s['oracle_observations']} completions observed, "
          f"{s.get('oracle_drift_triggers', 0)} drift triggers, "
          f"rolling nRMSE {s['oracle_nrmse']:.2e} (float noise only)")
    d, version = drifted_stream(gbt, rng, nodes, dev)
    print(f"  drifted world (service_time_fn): "
          f"{d.get('oracle_drift_triggers', 0)} drift triggers, "
          f"{d.get('oracle_refits', 0)} refits through the sim loop, "
          f"final rolling nRMSE {d['oracle_nrmse']:.4f} "
          f"(registry v{version})")


if __name__ == "__main__":
    main()
