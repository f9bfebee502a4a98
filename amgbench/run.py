"""Run one cell of ``BENCHMARK.json`` once on the card.

    python -m amgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up: the configuration's problem (its
generator, fixed sizes), the program's solver (its preset, fixed set-up
seed), the traffic's right-hand sides (from ``--seed``), and one untimed
solve that captures the solve's CUDA graph.  Then a closed loop of solves
for ``--seconds``, each timed on the host clock from the ``solve`` call
to x ready after ``torch.cuda.synchronize()``.  With ``--trace 1`` a
stretch of the window runs under ``torch.profiler`` and the per-layer
metrics are read after it; with ``--trace 0`` the end-to-end ones.
Then the plain reference (:mod:`amgbench.reference`) judges a sample of
the window's solves drawn from the seed and the slowest solve.  The last line of
standard output is the result as one JSON object.

Every metric is read by ``amgbench/metrics/<name>.py`` from a
:class:`Record` of the run; configurations, traffic mixes, generators
and presets are files found by name (``amgbench/README.md``).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import os
import random
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_amg")
PACKAGE = Path(__file__).resolve().parent
# the traced stretch: a third of the way into the window, at least this
# long and this many solves
STRETCH_SECONDS = 0.5
STRETCH_SOLVES = 5


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: dict  # trace (0 or 1) -> the BENCHMARK.json entries it reports
    chips: int


def load_cell(bench_path: Path, workload: str) -> Cell:
    """The cell named ``workload`` of the ``BENCHMARK.json`` at
    ``bench_path``, with its configuration file, its traffic mix and the
    metrics it reports."""
    spec = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((Path(bench_path).parent / entry["file"]).read_text())
    traffic = json.loads(
        (PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in reported]
    return Cell(name=workload, config=config, traffic=traffic,
                metrics={0: e2e, 1: per_layer}, chips=int(w["chips"]))


def module(kind: str, name: str):
    """``amgbench.<kind>.<name>``: a generator, a preset or a metric."""
    return importlib.import_module(f"amgbench.{kind}.{name}")


@dataclasses.dataclass
class Solve:
    index: int  # which right-hand side of the pool
    seconds: float
    iters: int
    converged: bool
    final_res: float


@dataclasses.dataclass
class Record:
    """What a run knows when its metrics are read."""

    config: dict
    problem: dict
    device: object  # torch.device
    solver: object
    probe: object  # a right-hand side, the vector the timings apply to
    spans: dict  # name -> host seconds
    setup_s: float
    window_s: float
    solves: list
    counts: tuple  # (before, after) the window: launch_counts() snapshots
    trace: object  # amgbench.trace.Summary, or None
    stretch_solves: int  # solves inside the traced stretch
    stretch_s: float  # the stretch's seconds on the host clock
    notes: dict  # what a metric leaves for the result line


@dataclasses.dataclass
class Window:
    """What the closed loop leaves: its solves and seconds, the x's the
    check judges (copied into buffers made before the window, so that
    keeping them allocates nothing inside it) and the traced stretch's
    extent."""

    solves: list
    seconds: float
    kept: object  # (checked, n) tensor: a seeded sample of the solves' x
    kept_at: list  # the index in solves of each kept x (None: unused)
    slowest_x: object
    slowest: object  # the index in solves of the slowest solve
    stretch_solves: int = 0  # solves inside the traced stretch
    stretch_s: float = 0.0  # its seconds on the host clock


def run_window(solver, pool, rtol, maxiter, seconds, sync, sample_seed,
               stretch=None, min_solves=0) -> Window:
    """The closed loop: solves until ``seconds`` have passed (and at least
    ``min_solves`` ran), the pool's right-hand sides in order.  A
    reservoir drawn from ``sample_seed`` keeps the x of as many solves as
    the pool has ``checked`` rows, each solve of the window as likely as
    any other; the slowest solve's x is kept besides."""
    size = pool.checked
    w = Window(solves=[], seconds=0.0,
               kept=torch.zeros(size, pool.b.shape[1], dtype=pool.b.dtype,
                                device=pool.b.device),
               kept_at=[None] * size, slowest_x=torch.zeros_like(pool.b[0]),
               slowest=None)
    draw = random.Random(sample_seed)
    solves = w.solves
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0

    def stop_stretch():
        stretch.stop()
        w.stretch_solves = len(solves) - w.stretch_solves
        w.stretch_s = time.perf_counter() - t_stretch

    try:
        while time.perf_counter() < t_end or len(solves) < min_solves:
            if (stretch is not None and not stretch.started
                    and time.perf_counter() - t_start >= seconds / 3):
                stretch.start()
                t_stretch = time.perf_counter()
                w.stretch_solves = len(solves)
            k = i % pool.b.shape[0]
            t0 = time.perf_counter()
            x, info = solver.solve(pool.b[k], None, rtol=rtol,
                                   maxiter=maxiter)
            sync()
            dt = time.perf_counter() - t0
            solves.append(Solve(k, dt, int(info.iters), bool(info.converged),
                                float(info.final_res)))
            s = len(solves) - 1
            slot = s if s < size else draw.randrange(s + 1)
            if slot < size:
                w.kept[slot].copy_(x)
                w.kept_at[slot] = s
            if w.slowest is None or dt > solves[w.slowest].seconds:
                w.slowest_x.copy_(x)
                w.slowest = s
            i += 1
            if (stretch is not None and stretch.active
                    and time.perf_counter() - t_stretch >= STRETCH_SECONDS
                    and len(solves) - w.stretch_solves >= STRETCH_SOLVES):
                stop_stretch()
    finally:
        if stretch is not None and stretch.active:
            stop_stretch()
    sync()
    w.seconds = time.perf_counter() - t_start
    return w


def cases(pool, window) -> list:
    """(b, x, reported ‖r‖₂) on the host in float64 for each solve the
    check judges: the kept sample and the slowest."""
    picked = [(j, window.kept[slot])
              for slot, j in enumerate(window.kept_at) if j is not None]
    if window.slowest is not None:
        picked.append((window.slowest, window.slowest_x))
    host = lambda t: t.double().cpu().numpy()
    return [(host(pool.b[window.solves[j].index]), host(x),
             window.solves[j].final_res) for j, x in picked]


def compare(config, traffic, problem, judged) -> dict:
    """The reference's numbers, on the host in float64, over the judged
    solves (:func:`cases`): the worst of each, with how many were
    checked."""
    from amgbench.reference import Checker, worst

    checker = Checker.build(problem, config["dtype"], float(traffic["rtol"]))
    per_solve = [checker.numbers(b, x, r) for b, x, r in judged]
    numbers = worst(per_solve)
    numbers["checked"] = len(per_solve)
    return numbers


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", build=None) -> dict:
    """One run of ``cell``; returns the result line's object, its
    compared numbers last.  ``build`` replaces the preset's ``build``
    (the control and the tests use it)."""
    from amgbench import traffic as traffic_gen
    from amgbench.reference import judge
    from tpu_amg_torch.solvers.graph import launch_counts

    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = process_seconds()
    problem = module("problems", config["generator"]).make(config)
    build = build or module("presets", config["preset"]).build
    sync()
    t1 = process_seconds()
    solver = build(problem, config, device)
    sync()
    t2 = process_seconds()
    spans = {"amg_setup_s": t2 - t1}
    pool = traffic_gen.make_pool(mix, problem, seed,
                                 getattr(torch, config["dtype"]), dev)
    rtol, maxiter = float(mix["rtol"]), int(config["maxiter"])
    sync()
    t3 = process_seconds()
    solver.solve(pool.b[0], None, rtol=rtol, maxiter=maxiter)
    sync()
    setup_s = process_seconds()
    print(f"set-up: start {t0!r} s, problem {t1 - t0!r} s, program "
          f"{t2 - t1!r} s, right-hand sides {t3 - t2!r} s, first solve "
          f"{setup_s - t3!r} s", file=sys.stderr)

    stretch = None
    if trace and cuda:
        from amgbench.trace import Stretch

        stretch = Stretch()
    before = launch_counts()
    window = run_window(solver, pool, rtol, maxiter, seconds, sync, seed,
                        stretch)
    after = launch_counts()
    solves, window_s = window.solves, window.seconds
    ms = sorted(1e3 * s.seconds for s in solves)
    print(f"window: {window_s!r} s, {len(ms)} solves, ms min {ms[0]!r} "
          f"median {ms[len(ms) // 2]!r} max {ms[-1]!r}, iterations "
          f"{sorted(collections.Counter(s.iters for s in solves).items())}",
          file=sys.stderr)
    record = Record(config=config, problem=problem, device=dev, solver=solver,
                    probe=pool.b[0], spans=spans, setup_s=setup_s,
                    window_s=window_s, solves=solves, counts=(before, after),
                    trace=stretch.read() if stretch is not None else None,
                    stretch_solves=window.stretch_solves,
                    stretch_s=window.stretch_s, notes={})
    metrics = {}
    for m in cell.metrics[1 if trace else 0]:
        value = module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)
                                            if cuda else 0)}
    if record.trace is not None:
        device_info.update(busy_s=record.trace.busy_s,
                           window_s=record.trace.window_s)

    # the program's state is freed before the reference runs
    judged = cases(pool, window)
    trace_summary, notes = record.trace, record.notes
    del solver, pool, record, window
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(config, mix, problem, judged)
    check_s = time.perf_counter() - t_check
    limits = config["limits"]
    result = {
        "correct": bool(solves) and judge(numbers, limits),
        "attempted": len(solves),
        "failed": sum(not s.converged for s in solves),
        "metrics": metrics,
        "device": device_info,
    }
    if trace_summary is not None:
        result["breakdown"] = {"device_ops": trace_summary.device_ops,
                               "idle_gaps": trace_summary.idle_gaps}
    result.update(notes)
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in limits}
    print(f"checked {numbers['checked']} solves in {check_s!r} s",
          file=sys.stderr)
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(Path.cwd() / "BENCHMARK.json", args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("modules that the benchmark may not load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
