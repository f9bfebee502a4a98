"""The benchmark's arithmetic, its files and its imports, on the CPU."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from amgbench import roofline, run, stats, trace
from amgbench.metrics import (device_idle_pct, solve_ms_p95, solves_per_s,
                              spmv_launches_per_solve)

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def record(solves, window_s=2.0, counts=({}, {}), trace=None,
           stretch_solves=0, stretch_s=0.0):
    return run.Record(config={}, problem={}, device=None, solver=None,
                      probe=None, spans={}, setup_s=1.0, window_s=window_s,
                      solves=solves, counts=counts, trace=trace,
                      stretch_solves=stretch_solves, stretch_s=stretch_s,
                      notes={})


def solve(seconds, converged=True):
    return run.Solve(index=0, seconds=seconds, iters=7, converged=converged,
                     final_res=0.0)


def test_rate_is_over_the_whole_window():
    solves = [solve(0.01)] * 30 + [solve(0.5, converged=False)] * 2
    assert solves_per_s.read(record(solves, window_s=3.0)) == 30 / 3.0


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 613):
        xs = list(rng.exponential(size=n))
        for q in (50, 95, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12)


def test_p95_counts_a_failed_solve_as_missing():
    ok = [solve(0.001 * (i + 1)) for i in range(100)]
    assert solve_ms_p95.read(record(ok)) == pytest.approx(
        float(np.percentile([1.0 * (i + 1) for i in range(100)], 95)))
    # a failure in the tail pushes every faster solve down a rank
    failed = ok[:99] + [solve(0.0001, converged=False)]
    slow = solve_ms_p95.read(record(failed))
    assert slow > solve_ms_p95.read(record(ok[:99]))
    # more than 5% failed: the tail is a failure, and no number is given
    many = ok[:90] + [solve(0.0001, converged=False)] * 10
    assert solve_ms_p95.read(record(many)) is None
    assert math.isinf(stats.percentile([1.0, math.inf], 95))


def test_roofline_bytes_and_bound():
    # poisson3d(200) in float64: 7·200³ − 6·200² values, two 200³ vectors
    assert roofline.spmv_bytes(55_760_000, 200 ** 3, 8, 8) == 574_080_000
    # ex1p's system in float64: 324,105 values, 65,025 rows
    assert roofline.spmv_bytes(324_105, 65_025, 8, 8) == 3_633_240

    def probe():
        raise AssertionError("the L2 probe runs only for an L2 working set")

    assert roofline.bound(574_080_000, probe) == (
        roofline.HBM_GBPS, "HBM data sheet")
    assert roofline.bound(3_633_240, lambda: 7000.0)[0] == 7000.0
    # 3,633,240 bytes at 7,000 GB/s take 0.51903 us: 10% of 5.1903 us
    assert roofline.share_pct(3_633_240, 7000.0, 0.0051903) == pytest.approx(
        10.0, rel=1e-4)


def test_launches_are_differenced_over_the_window():
    before = {"csr_spmv_launches": 10, "coo_patch_launches": 4,
              "dia_spmv_launches": 100, "csr_spmv_launches_by_shape": {}}
    after = {"csr_spmv_launches": 70, "coo_patch_launches": 24,
             "dia_spmv_launches": 400, "csr_spmv_launches_by_shape": {}}
    rec = record([solve(0.01)] * 20, counts=(before, after))
    assert spmv_launches_per_solve.read(rec) == (60 + 20 + 300) / 20


def test_idle_share_is_of_the_untraced_window():
    # 100 solves in 2 s, 10 of them in a traced stretch of 0.4 s whose
    # device was busy 0.1 s: 0.01 s a solve, so 90 solves keep the device
    # busy 0.9 of the 1.6 untraced seconds
    t = trace.Summary(window_s=0.4, busy_s=0.1, device_ops=[], idle_gaps=[])
    rec = record([solve(0.02)] * 100, window_s=2.0, trace=t,
                 stretch_solves=10, stretch_s=0.4)
    assert device_idle_pct.read(rec) == pytest.approx(100 * (1 - 0.9 / 1.6))
    assert device_idle_pct.read(record([solve(0.02)] * 100, trace=t)) is None
    assert device_idle_pct.read(record([solve(0.02)] * 100)) is None


def test_trace_summary():
    span = {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
            "ts": 1000.0, "dur": 100.0}
    events = [
        span,
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 990.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1005.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1050.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1095.0,
         "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 1020.0, "dur": 40.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1072.0,
         "dur": 20.0},
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [1000, 1015] (k1 clipped, k2 inside it), [1050, 1070], [1095, 1100]
    assert s.busy_s == pytest.approx(40e-6)
    assert s.device_ops[0] == ["k1", pytest.approx(30e-6)]
    assert dict(s.idle_gaps) == {"cudaGraphLaunch": pytest.approx(35e-6),
                                 "aten::item": pytest.approx(25e-6)}
    assert trace.summarize([e for e in events if e is not span]) is None


def test_readers_match_the_benchmark():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            mod = run.module("metrics", m["name"])
            assert mod.UNIT == m["unit"], m["name"]
            assert mod.MOVES == m.get("moves", m["name"]), m["name"]
            if kind == "per_layer":
                assert mod.LAYER == m["layer"], m["name"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["amgbench"]
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("amgbench/")
        config = json.loads((REPO / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert all(key in config for key in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert (REPO / "amgbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _modules_after(
        "from pathlib import Path\n"
        "from amgbench import run\n"
        "cell = run.load_cell(Path('BENCHMARK.json'), 'poisson3d_7pt_200.cold')\n"
        "cell.config['n'] = 12\n"
        "assert run.run_cell(cell, 5, 0.2, False, 'cpu')['correct']\n"
        "assert run.forbidden_modules() == []")
    assert "tpu_amg_torch" in loaded  # the program ran; its name is whole
    assert not loaded & set(run.FORBIDDEN)


def test_the_reference_takes_nothing_of_the_program():
    loaded = _modules_after(
        "import amgbench.reference, amgbench.traffic, amgbench.stats, "
        "amgbench.roofline, amgbench.problems.poisson3d_7pt, "
        "amgbench.problems.fem2d_p1")
    assert "tpu_amg_torch" not in loaded
    assert not loaded & set(run.FORBIDDEN)
