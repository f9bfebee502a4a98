"""The readings that the limits of ``correct`` are set from.

    python -m amgbench.control --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... [--seconds 2] [--device cuda]

In one process: the cell's problem and the program's set-up once; for
each of ``--seeds`` the traffic's right-hand sides and a short window at
the cell's own load that solves every one of them at least once, judged
as a run judges them (:func:`amgbench.run.compare`); then the same for
the configuration's ``control`` on ``--control-seeds``: the program's own
lower-precision path, the preset built in the control's ``dtype``.
One JSON line a seed, then the largest reading of the program and the
smallest of the control for each compared number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from amgbench import run


def control_solver(config: dict, problem: dict, device: str):
    """The program set up in the control's lower precision; its solves
    take the configuration's right-hand sides, cast to that precision."""
    c = config["control"]
    if c["kind"] != "program":
        raise ValueError(f"unknown control kind {c['kind']!r}")
    return run.module("presets", config["preset"]).build(
        problem, dict(config, dtype=c["dtype"]), device)


def readings(cell, solver, problem, seeds, seconds, device, side) -> list:
    import torch

    from amgbench import traffic as traffic_gen

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mix, config = cell.traffic, cell.config
    rows = []
    for seed in seeds:
        pool = traffic_gen.make_pool(mix, problem, seed,
                                     getattr(torch, config["dtype"]), dev)
        window = run.run_window(
            solver, pool, float(mix["rtol"]), int(config["maxiter"]), seconds,
            sync, seed, min_solves=pool.b.shape[0])
        numbers = run.compare(config, mix, problem, run.cases(pool, window))
        solves = window.solves
        row = dict(side=side, seed=seed, solves=len(solves),
                   window_s=window.seconds,
                   failed=sum(not s.converged for s in solves),
                   iters=sum(s.iters for s in solves) / len(solves), **numbers)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default="BENCHMARK.json")
    args = ap.parse_args(argv)
    cell = run.load_cell(Path(args.bench), args.workload)
    config = cell.config
    problem = run.module("problems", config["generator"]).make(config)
    solver = run.module("presets", config["preset"]).build(
        problem, config, args.device)
    program = readings(cell, solver, problem, args.seeds, args.seconds,
                       args.device, "program")
    del solver
    control = []
    if args.control_seeds:
        control = readings(cell, control_solver(config, problem, args.device),
                           problem, args.control_seeds, args.seconds,
                           args.device, "control")
    summary = {k: {"lower": max(r[k] for r in program),
                   "upper": min((r[k] for r in control), default=None)}
               for k in config["limits"]}
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
