"""The port's collating benches (``repro_torch.bench.{roofline,report,
write_experiments,perf_experiments,run}``) against the reference's
``benchmarks/`` scripts on the CPU.

- roofline: the port's rows equal the reference's for the same record
  written in each package's format (ok, FAILED, skipped, a missing file),
  and hold on a real port dry-run on the (4, 2) abstract mesh;
- report: the committed ``BENCH_3…7.json`` rows, read by both packages
  under their own names, give the same headlines;
- write_experiments: the figure tables equal the reference's line for
  line; the document states the H100's rates and none of the reference's
  TPU figures, and goes only to its ``--out``;
- perf_experiments: the reference's ten experiments (read with ``ast``,
  never run), ``REPRO_FORCE_FSDP`` cleared after a run, one that raises
  recorded, and a real A0 / A1 pair;
- run: the reference's ten benches in its order, its filter and its
  failure count, and a device resolved before any bench.

No reference ``main()`` writes anywhere but ``tmp_path``; the last test
holds the repository's collated outputs untouched.
"""
import ast
import importlib
import json
import os
import pathlib

import pytest
import torch

from repro_torch.bench import common as pcommon
from repro_torch.bench import perf_experiments as pperf
from repro_torch.bench import report as preport
from repro_torch.bench import roofline as proof
from repro_torch.bench import run as prun
from repro_torch.bench import write_experiments as pwrite
from repro_torch.configs import reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed.context import AbstractMesh
from repro_torch.launch import dryrun
from repro_torch.roofline import H100_SXM

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: the outputs the collating scripts of either package could write in
#: the repository
OUTPUTS = ("EXPERIMENTS.md", "results/EXPERIMENTS_torch.md",
           "results/perf_experiments.json",
           "results/perf_experiments_torch.json",
           "results/bench_roofline.json", "results/bench_torch_roofline.json")
TPU_FIGURES = ("197 TFLOP/s", "819 GB/s", "v5e", "16G")


def outputs_state() -> list:
    return [(p, (ROOT / p).stat().st_mtime_ns if (ROOT / p).exists()
             else None) for p in OUTPUTS]


@pytest.fixture(scope="module", autouse=True)
def untouched_outputs():
    """The repository's collated outputs as they were before this module's
    tests."""
    return outputs_state()


@pytest.fixture
def results(tmp_path, monkeypatch):
    """Both packages' rows under ``tmp_path``; the reference's scripts
    importable as ``benchmarks.*``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import common as bcommon
    monkeypatch.setattr(bcommon, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(pcommon, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    return tmp_path


def ref_script(name):
    return importlib.import_module(f"benchmarks.{name}")


def dump(path, obj):
    path.write_text(json.dumps(obj))
    return str(path)


# -- roofline --------------------------------------------------------------
def port_record(arch, shape, compute, memory, collective, nbytes, fits):
    terms = {"compute": compute, "memory": memory, "collective": collective}
    return {"arch": arch, "shape": shape, "status": "ok",
            "bytes_per_device": nbytes, "fits_hbm80": fits,
            "roofline": {"compute_s": compute, "memory_s": memory,
                         "collective_s": collective,
                         "dominant": max(terms, key=terms.get),
                         "useful_ratio": 0.42, "model_flops": 1e15}}


def as_reference(rec: dict) -> dict:
    """A port dry-run record in the reference's format: its size as the
    TPU-adjusted one, its fit as ``fits_hbm16``."""
    rec = dict(rec)
    if rec["status"] == "ok":
        rec["bytes_per_device_tpu_adjusted"] = rec.pop("bytes_per_device")
        rec["fits_hbm16"] = rec.pop("fits_hbm80")
    return rec


def as_port_rows(rows: list[dict]) -> list[dict]:
    return [{("fits_hbm80" if k == "fits_hbm16" else k): v
             for k, v in r.items()} for r in rows]


HAND_RECORDS = [
    port_record("gemma-2b", "train_4k", 0.3, 1e-4, 0.02, 15.5 * 2**30,
                True),
    port_record("qwen3-1.7b", "decode_32k", 4e-5, 3e-4, 1e-2, 90e9, False),
    {"arch": "zamba2-1.2b", "shape": "prefill_32k", "status": "FAILED",
     "error": "RuntimeError: boom"},
    {"arch": "whisper-tiny", "shape": "long_500k", "status": "skipped",
     "reason": "no 500k-token decoder for whisper (skip policy)"},
]


def test_roofline_rows_equal_the_reference(results):
    ref = ref_script("bench_roofline")
    want = ref.main(dump(results / "ref.json",
                         [as_reference(r) for r in HAND_RECORDS]))
    got = proof.main(dump(results / "port.json", HAND_RECORDS),
                     device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert got == as_port_rows(want)
    assert [r.get("status") for r in got] == [None, None, "FAILED",
                                              "skipped"]
    assert json.loads((results / "bench_torch_roofline.json").read_text()) \
        == got


def test_roofline_missing_file_is_skipped(results, capsys, monkeypatch):
    ref = ref_script("bench_roofline")
    monkeypatch.setattr(ref, "RESULTS_DIR", str(results))
    assert ref.main() == []
    want = capsys.readouterr().out
    assert proof.main(device="cpu") == []
    got = capsys.readouterr().out
    assert want.startswith("roofline,,skipped=no ")
    assert got.startswith("roofline,,skipped=no ")
    assert str(results / proof.DRYRUN_NAME) in got
    assert not list(results.iterdir())


def test_roofline_needs_the_card_unless_asked_for_the_cpu(results,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        proof.main(dump(results / "port.json", HAND_RECORDS))


SMALL_SHAPES = {"t64": InputShape("t64", 64, 8, "train"),
                "p64": InputShape("p64", 64, 8, "prefill"),
                "d64": InputShape("d64", 64, 8, "decode")}


@pytest.fixture(scope="module")
def small_dryrun():
    """The port's dry-run records of the reduced qwen3 train, deepseek-moe
    prefill and zamba2 decode on a (4, 2) abstract mesh (meta tensors)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "make_production_mesh", lambda multi_pod=False:
                   AbstractMesh((4, 2), ("data", "model")))
        mp.setattr(dryrun, "get_config", reduced_config)
        for name, shape in SMALL_SHAPES.items():
            mp.setitem(dryrun.INPUT_SHAPES, name, shape)
        return [dryrun.run_one(arch, shape, verbose=False)
                for arch, shape in (("qwen3-1.7b", "t64"),
                                    ("deepseek-moe-16b", "p64"),
                                    ("zamba2-1.2b", "d64"))]


def test_roofline_over_a_real_dryrun(results, small_dryrun):
    recs = small_dryrun
    assert [r["status"] for r in recs] == ["ok"] * 3
    assert all(r["mesh"] == "4x2" for r in recs)
    got = proof.main(dump(results / "port.json", recs), device="cpu")
    want = ref_script("bench_roofline").main(
        dump(results / "ref.json", [as_reference(r) for r in recs]))
    assert got == as_port_rows(want)
    for row, rec in zip(got, recs):
        terms = {k: row[f"{k}_s"] for k in ("compute", "memory",
                                            "collective")}
        assert row["us_per_call"] == rec["roofline"]["bound_s"] * 1e6 > 0
        assert row["dominant"] == max(terms, key=terms.get)
        assert row["mem_gib_per_dev"] == rec["bytes_per_device"] / 2**30
        assert row["fits_hbm80"] is True


# -- report ----------------------------------------------------------------
def committed_baselines() -> dict:
    return {n: json.loads((ROOT / f"BENCH_{n}.json").read_text())
            for n in preport.FILES}


def write_both(tmp_path, baselines, card_rows=False):
    """The rows as the reference's ``BENCH_<n>.json`` under ``ref/`` and
    as the port's ``bench_torch_<name>.json`` under ``port/``."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    for n, rows in baselines.items():
        dump(ref_dir / f"BENCH_{n}.json", rows)
        if card_rows:
            rows = [dict(r, card=CARD) for r in rows]
        dump(port_dir / f"bench_torch_{preport.FILES[n]}.json", rows)
    return ref_dir, port_dir


@pytest.mark.parametrize("card_rows", [False, True],
                         ids=["cpu_rows", "card_rows"])
def test_report_headlines_equal_the_reference(results, monkeypatch,
                                              card_rows):
    ref = ref_script("report")
    ref_dir, port_dir = write_both(results, committed_baselines(), card_rows)
    monkeypatch.setattr(ref, "ROOT", str(ref_dir))
    want = {e["subsystem"]: e for e in ref.collect()}
    got = {e["subsystem"]: e for e in preport.collect(str(port_dir))}
    assert list(got) == list(want) and len(got) == 5
    for name, w in want.items():
        g = got[name]
        for key in ("comparison", "config", "speedup", "throughput"):
            assert g[key] == w[key], (name, key)
        assert g["card"] == (CARD if card_rows else "cpu")
        assert g["bench"] == f"bench_torch_{preport.FILES[int(w['bench'][6:])]}"


def test_report_cli_reads_results_and_writes_only_out(results, capsys,
                                                      monkeypatch):
    _, port_dir = write_both(results, committed_baselines(), True)
    before = sorted(p.name for p in port_dir.iterdir())
    out = results / "table" / "report.md"
    entries = preport.main(["--results", str(port_dir), "--out", str(out)])
    printed = capsys.readouterr().out
    assert len(entries) == 5
    table = out.read_text()
    assert table.strip() == preport.table(entries)
    assert table.strip() in printed
    assert table.splitlines()[0].endswith("| card |")
    assert all(line.endswith(f"| {CARD} |")
               for line in table.strip().splitlines()[2:])
    assert sorted(p.name for p in port_dir.iterdir()) == before
    # REPRO_RESULTS names the default directory
    monkeypatch.setattr(pcommon, "RESULTS_DIR", str(port_dir))
    assert preport.collect() == entries


def test_report_skips_missing_and_speedless_files(results):
    baselines = committed_baselines()
    dump(results / "bench_torch_stream.json", baselines[4])
    dump(results / "bench_torch_oracle.json",
         [{"name": "x", "us_per_call": 1.0}])
    entries = preport.collect(str(results))
    assert [e["subsystem"] for e in entries] == ["streaming re-planning"]


# -- write_experiments -----------------------------------------------------
FIG2A = [{"name": f"fig2a_mlp_{s}", "params": p, "nrmse_mean": v,
          "nrmse_flops": v / 2}
         for s, p, v in (("xs", 3012, 0.03125), ("s", 12345, 0.02417),
                         ("xl", 4170000, 0.01875))]
FIG2B = [{"name": f"fig2b_gbt_d{d}_s{s}", "max_depth": d, "subsample": s,
          "nrmse_mean": v, "nrmse_flops": v / 10, "nrmse_macs": v / 11,
          "nrmse_total_time": v * 2.5}
         for d, s, v in ((2, 0.5, 0.0412), (12, 0.8, 0.0121))]
FIG3 = [{"name": "fig3_gbt_best", "nrmse_flops": 1.5e-5,
         "nrmse_macs": 2.25e-5, "nrmse_total_time": 0.0375,
         "gbt_vs_mlp_ratio": 123.4}]


def write_figs(root, card_rows=False):
    figs = {"fig2a_mlp": FIG2A, "fig2b_gbt": FIG2B,
            "fig3_predictions": FIG3}
    for name, rows in figs.items():
        if card_rows:
            rows = rows + [dict(r, name=f"{r['name']}_kernel", card=CARD)
                           for r in rows]
        dump(root / f"bench_torch_{name}.json", rows)
    return figs


def test_bench_tables_equal_the_reference_line_for_line(results,
                                                        monkeypatch):
    ref = ref_script("write_experiments")
    ref_dir = results / "ref"
    ref_dir.mkdir()
    for name, rows in write_figs(results).items():
        dump(ref_dir / f"bench_{name}.json", rows)
    monkeypatch.setattr(ref, "R", str(ref_dir))
    want = ref.bench_tables().splitlines()
    got = pwrite.bench_tables(str(results)).splitlines()
    assert len(want) >= 15
    assert got == want


def test_fig2a_plateau_is_read_from_the_rows(results, monkeypatch):
    """The reference says "matches" whatever its rows hold; the port says
    so only where the largest MLP is below the paper's 0.02."""
    ref = ref_script("write_experiments")
    high = [dict(r, nrmse_mean=r["nrmse_mean"] + 0.01) for r in FIG2A]
    dump(results / "bench_torch_fig2a_mlp.json", high)
    dump(results / "bench_fig2a_mlp.json", high)
    monkeypatch.setattr(ref, "R", str(results))
    assert "**matches** (ours 0.029–0.041)" in ref.bench_tables()
    assert "**does not match** (ours 0.029–0.041)" in \
        pwrite.bench_tables(str(results))


def test_bench_tables_add_the_card_rows_apart(results):
    write_figs(results)
    cpu_only = pwrite.bench_tables(str(results))
    write_figs(results, card_rows=True)
    both = pwrite.bench_tables(str(results))
    for line in cpu_only.splitlines():
        assert line in both.splitlines()
    assert both.count(f"kernel path on {CARD}") == 3
    assert "| xs | 3,012 | 0.0312 |" in both
    assert "xs_kernel" not in both


def perf_record(name, compute, collective, nbytes, status="ok"):
    if status != "ok":
        return {"experiment": name, "hypothesis": "h", "status": status,
                "error": "RuntimeError: boom"}
    return {"experiment": name, "hypothesis": f"lever of {name}",
            "status": "ok", "bytes_per_device": nbytes,
            "roofline": {"compute_s": compute, "memory_s": 1e-3,
                         "collective_s": collective,
                         "dominant": "compute" if compute > collective
                         else "collective"}}


def test_document_states_the_h100_and_no_tpu_figures(results, monkeypatch,
                                                     small_dryrun):
    write_figs(results, card_rows=True)
    dump(results / "dryrun_torch.json",
         small_dryrun + [HAND_RECORDS[2], HAND_RECORDS[3]])
    recs = [perf_record("A0_baseline_mla_naive", 4e-3, 3e-2, 2e10),
            perf_record("A1_mla_absorbed", 5e-5, 3e-2, 1.9e10),
            perf_record("B0_baseline_fsdp", 0.2, 4e-3, 1.8e10,
                        status="FAILED")]
    pperf.compare(recs)
    dump(results / "perf_experiments_torch.json", recs)
    cwd = results / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = results / "doc" / "exp.md"
    assert pwrite.main(["--results", str(results), "--out", str(out)]) \
        == str(out)
    doc = out.read_text()
    assert not list(cwd.iterdir())
    assert not (results / pwrite.OUT_NAME).exists()
    for heading in ("## §Paper-validation", "## §Dry-run", "### Single pod",
                    "### Multi-pod", "## §Roofline", "## §Perf"):
        assert heading in doc
    hw = H100_SXM
    for rate in (f"{hw.peak_flops / 1e12:g} TFLOP/s",
                 f"{hw.hbm_bw / 1e12:g} TB/s", f"{hw.link_bw / 1e9:g} GB/s"):
        assert rate in doc
    for figure in TPU_FIGURES:
        assert figure not in doc
    assert "| qwen3-1.7b | t64 | ok |" in doc
    assert "| zamba2-1.2b | prefill_32k | FAILED |" in doc
    assert "compute 0.0125×" in doc
    assert "**confirmed**" in doc
    assert "B0_baseline_fsdp** — FAILED" in doc
    assert pwrite.bench_tables(str(results)) in doc


def test_document_default_path_is_the_ports(results):
    path = pwrite.main(["--results", str(results)])
    assert path == str(results / "EXPERIMENTS_torch.md")
    doc = pathlib.Path(path).read_text()
    assert doc.count("No records: not run.") == 3


# -- perf_experiments ------------------------------------------------------
def reference_experiments() -> list[dict]:
    """The reference's experiment list, read from its source."""
    tree = ast.parse((ROOT / "benchmarks/perf_experiments.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "experiments")
    return [{kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
            for call in node.value.elts]


def knobs(ex: dict) -> tuple:
    return (ex["name"], ex["arch"], ex["shape"], ex.get("kw"),
            ex.get("force_fsdp", False), ex.get("seq_shard_cache", False))


def test_experiments_equal_the_references():
    want = reference_experiments()
    assert len(want) == 10
    assert [knobs(e) for e in pperf.EXPERIMENTS] == [knobs(e) for e in want]
    for ex in pperf.EXPERIMENTS:
        assert ex["hypothesis"]
        for figure in ("->3.", "(-31%)", "GiB", "0.9GB", "16G",
                       "CONFIRMED", "REFUTED"):
            assert figure not in ex["hypothesis"], (ex["name"], figure)
        if "predicts" in ex:
            term, direction, against = ex["predicts"]
            assert term in pperf.RATIO_KEYS and direction in ("up", "down")
            assert against[0] == ex["name"][0] and against < ex["name"]
    assert {pperf.baseline_of(e["name"]) for e in pperf.EXPERIMENTS} == {
        "A0_baseline_mla_naive", "B0_baseline_fsdp", "C0_baseline_sp"}


def test_run_clears_force_fsdp_and_records_a_raising_run(results,
                                                         monkeypatch):
    monkeypatch.delenv(pperf.FORCE_FSDP, raising=False)
    seen = []
    collective = {"B0_baseline_fsdp": 4e-3, "B1_no_fsdp": 3e-3,
                  "B3_pin_inner": 3e-3}

    def fake_run_one(arch, shape, *, seq_shard_cache=False,
                     extra_cfg_kw=None):
        ex = pperf.EXPERIMENTS[len(seen)]
        assert (arch, shape, seq_shard_cache, extra_cfg_kw) == (
            ex["arch"], ex["shape"], ex.get("seq_shard_cache", False),
            ex["kw"])
        seen.append((ex["name"], os.environ.get(pperf.FORCE_FSDP)))
        if ex["name"] == "C1_bf16_psum":
            raise RuntimeError("boom")
        rec = perf_record(ex["name"], 0.25, collective.get(ex["name"], 0.1),
                          2.2e10 if ex["name"] == "B1_no_fsdp" else 2e10)
        rec.update(arch=arch, shape=shape)
        return rec

    monkeypatch.setattr(dryrun, "run_one", fake_run_one)
    recs = pperf.run()
    assert [r["experiment"] for r in recs] == [
        e["name"] for e in pperf.EXPERIMENTS]
    assert seen == [(e["name"], "1" if e.get("force_fsdp") else None)
                    for e in pperf.EXPERIMENTS]
    assert pperf.FORCE_FSDP not in os.environ
    failed = next(r for r in recs if r["experiment"] == "C1_bf16_psum")
    assert failed["status"] == "FAILED" and "boom" in failed["error"]
    by = {r["experiment"]: r for r in recs}
    assert by["B1_no_fsdp"]["verdict"] == "confirmed"
    assert by["B3_pin_inner"]["verdict"] == "unchanged"
    assert by["B1_no_fsdp"]["vs_baseline"]["collective_s"] == 0.75
    assert by["B1_no_fsdp"]["vs_baseline"]["bytes_per_device"] == \
        pytest.approx(1.1)
    assert by["B0_baseline_fsdp"]["verdict"] == "baseline"
    written = json.loads(
        (results / "perf_experiments_torch.json").read_text())
    assert [r["experiment"] for r in written] == list(by)
    assert not (results / "perf_experiments.json").exists()


def test_force_fsdp_restores_the_callers_value(monkeypatch):
    monkeypatch.setenv(pperf.FORCE_FSDP, "yes")
    with pperf.forced_fsdp(False):
        assert pperf.FORCE_FSDP not in os.environ
    assert os.environ[pperf.FORCE_FSDP] == "yes"
    with pytest.raises(KeyError):
        with pperf.forced_fsdp(True):
            assert os.environ[pperf.FORCE_FSDP] == "1"
            raise KeyError
    assert os.environ[pperf.FORCE_FSDP] == "yes"


@pytest.mark.parametrize("now,direction,want", [
    (1.0, "down", "confirmed"), (3.0, "down", "refuted"),
    (2.0, "down", "unchanged"), (3.0, "up", "confirmed"),
    (1.0, "up", "refuted")])
def test_verdict_reads_the_move_against_the_prediction(now, direction,
                                                       want):
    rec = perf_record("X1", now, 0.0, 1.0)
    before = perf_record("X0", 2.0, 0.0, 1.0)
    assert pperf.verdict(rec, before, "compute_s", direction) == want


def test_absorption_cuts_the_compute_term(results):
    recs = pperf.run([e for e in pperf.EXPERIMENTS
                      if e["name"][:2] in ("A0", "A1")],
                     out=str(results / "pair_a.json"))
    a0, a1 = recs
    assert a0["status"] == a1["status"] == "ok"
    assert a1["roofline"]["compute_s"] < 0.2 * a0["roofline"]["compute_s"]
    assert a1["verdict"] == "confirmed"
    assert a1["vs_baseline"]["compute_s"] < 0.2
    assert json.loads((results / "pair_a.json").read_text())[1][
        "experiment"] == "A1_mla_absorbed"


# -- run -------------------------------------------------------------------
def reference_benches() -> list[tuple]:
    """(header, module) of the reference's ``benches`` list."""
    tree = ast.parse((ROOT / "benchmarks/run.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "benches")
    return [(ast.literal_eval(t.elts[0]), t.elts[1].value.id)
            for t in node.value.elts]


def test_run_has_the_references_benches_in_order():
    want = reference_benches()
    assert len(want) == 10
    assert list(prun.BENCHES) == [(h, m.removeprefix("bench_"))
                                  for h, m in want]


@pytest.fixture
def fake_benches(monkeypatch):
    """Each bench's ``main`` replaced by a recorder; ``fail`` names the
    benches that raise."""
    calls, fail = [], set()

    def fake(module):
        def main(device=None):
            calls.append((module, device))
            if module in fail:
                raise RuntimeError(f"{module} broke")
            return []
        return main

    for _, module in prun.BENCHES:
        mod = importlib.import_module(f"repro_torch.bench.{module}")
        monkeypatch.setattr(mod, "main", fake(module))
    return calls, fail


def test_run_filters_by_header(fake_benches, capsys):
    calls, _ = fake_benches
    prun.main(["sched", "--device", "cpu"])
    assert calls == [("scheduler", torch.device("cpu"))]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# === scheduler (paper §II-D) ==="
    assert out[1].startswith("# --- scheduler (paper §II-D) done in ")


def test_run_counts_failures_after_running_the_rest(fake_benches, capsys):
    calls, fail = fake_benches
    fail.update({"fig2b_gbt", "kernels"})
    with pytest.raises(SystemExit) as e:
        prun.main(["--device", "cpu"])
    assert e.value.code == "2 benchmark(s) failed"
    assert [m for m, _ in calls] == [m for _, m in prun.BENCHES]
    err = capsys.readouterr().err
    assert "fig2b_gbt broke" in err and "kernels broke" in err


def test_run_resolves_the_device_before_any_bench(fake_benches,
                                                  monkeypatch):
    calls, _ = fake_benches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prun.main([])
    assert calls == []


def test_no_collated_output_in_the_repository(untouched_outputs):
    """Last: no test of this module wrote the reference's or the port's
    collated outputs into the repository."""
    assert outputs_state() == untouched_outputs
