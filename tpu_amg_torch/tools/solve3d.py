"""Solve with a checkpointed 3-D unstructured hierarchy: the port of the
JAX package's ``tools/solve3d.py``.

Rebuilds the system of ``tools.setup3d`` (``--side``,
``--elasticity``), loads the checkpoint it saved, and prints each
level's format (DIA: K3; CSR: K1 + K2; dense), rows, stored entries and
block size, the V-cycle's time (eager, and on a CUDA device its own
time, a CUDA graph replayed), and the PCG solve of A x = A x_true
(seeded x_true) to rtol 1e-6, through ``AMGSolver.solve`` (a CUDA graph
an iteration on the card; the first solve captures it, the second is
timed).  The last line is one JSON object.

Usage: python -m tpu_amg_torch.tools.solve3d [--elasticity] [--side 101] [--ckpt build/h3d.npz] [--device cuda]
"""

import argparse
import json
import sys
import time

import numpy as np

RTOL = 1e-6
MAXITER = 300


def level_table(mg, hierarchy) -> list:
    """One line a level of ``mg`` built from ``hierarchy``: its format
    (DIA: K3; CSR: K1 + K2; dense), rows, stored entries, block size."""
    from tpu_amg_torch.linop import DenseOperator
    from tpu_amg_torch.sparse.dia import DIA

    lines = []
    for lvl, host in enumerate(hierarchy.matrices):
        if lvl < len(mg.levels):
            op = mg.levels[lvl].a
            if isinstance(op, DenseOperator):
                fmt = "dense"
            elif isinstance(op.mat, DIA):
                fmt = f"DIA (K3, {len(op.mat.offsets)} diagonals)"
            else:
                fmt = f"CSR (K1 + K2, tail {op.mat.n_tail})"
        else:
            fmt = f"coarse: {coarse_description(mg.coarse_solver)}"
        lines.append(f"level {lvl}: n={host.nrows} nnz={host.nnz} "
                     f"({host.nnz / host.nrows:.1f}/row) "
                     f"block={host.block_size} {fmt}")
    return lines


def coarse_description(coarse) -> str:
    """What a multigrid's coarse solve is: the dense Cholesky inverse,
    the dense pseudo-inverse, or the banded Cholesky factor (its RCM
    bandwidth b, block size s and block count nb)."""
    from tpu_amg_torch.preconditioners.coarse import (
        BandedCholeskySolver,
        DensePinvSolver,
    )

    if isinstance(coarse, BandedCholeskySolver):
        nb, s, _ = coarse.inv_l_diag.shape
        return (f"banded Cholesky (b={coarse.bandwidth}, s={s}, nb={nb}, "
                f"{coarse.device_bytes() / 1e6:.1f} MB)")
    if isinstance(coarse, DensePinvSolver):
        return "dense pseudo-inverse"
    return "dense Cholesky inverse"


def vcycle_ms(mg, x, device, reps: int):
    """(eager ms, device ms) per V-cycle: on a CUDA device the cycle
    enqueued from Python, and a CUDA graph of ``reps`` cycles replayed;
    on the CPU the host clock (a number of the CPU) and None."""
    from tpu_amg_torch.utils.timing import call_ms, median_ms

    if device.type == "cuda":
        return (median_ms(lambda: mg.mv(x), reps),
                median_ms(lambda: mg.mv(x), reps, graph=True))
    return call_ms(lambda: mg.mv(x), device, reps), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=101)
    ap.add_argument("--ckpt", type=str, default="build/h3d.npz")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--elasticity", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.tools.setup3d import build_problem, config

    resolve_device(args.device)  # before the system: no card, no build
    t0 = time.perf_counter()
    a = build_problem(args.side, args.elasticity)
    print(f"# system n={a.nrows} nnz={a.nnz} rebuilt "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    cfg = config(args.elasticity, args.device)
    t0 = time.perf_counter()
    solver = AMGSolver.load(args.ckpt, a, cfg)
    print(f"# load+mg build {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    mg = solver.preconditioner
    for line in level_table(mg, solver.hierarchy):
        print("# " + line, file=sys.stderr, flush=True)

    dev = solver.device
    x = torch.ones(a.nrows, dtype=cfg.dtype, device=dev)
    eager_ms, device_ms = vcycle_ms(mg, x, dev, args.reps)
    print(f"# vcycle eager {eager_ms:.3f}ms, device "
          + ("not measured (CPU)" if device_ms is None
             else f"{device_ms:.3f}ms (CUDA graph replay)"),
          file=sys.stderr, flush=True)

    x_true = torch.from_numpy(
        np.random.default_rng(3).normal(size=a.nrows)).to(dev, cfg.dtype)
    b = solver.op.mv(x_true)
    solver.solve(b, rtol=RTOL, maxiter=MAXITER)  # captures the graph
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    xs, info = solver.solve(b, rtol=RTOL, maxiter=MAXITER)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_solve = time.perf_counter() - t0
    true_rel = float(torch.linalg.vector_norm(b - solver.op.mv(xs))
                     / torch.linalg.vector_norm(b))
    print(f"# solve: {dt_solve * 1e3:.1f}ms {info.iters} iters, converged "
          f"{info.converged}, true relative residual {true_rel:.3e}",
          file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": ("unstructured3d_elasticity_solve_" if args.elasticity
                   else "unstructured3d_poisson_solve_") + str(a.nrows),
        "value": dt_solve * 1e3,
        "unit": "ms",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "vcycle_ms": eager_ms,
        "vcycle_device_ms": device_ms,
        "iters": info.iters,
        "converged": bool(info.converged),
        "true_rel_residual": true_rel,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
