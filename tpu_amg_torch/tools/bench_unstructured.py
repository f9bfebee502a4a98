"""Unstructured-FEM end-to-end bench: the port of the JAX package's
``bench_unstructured.py``.  V-cycle and AMG-PCG solve times on a
Delaunay-triangulated FEM-graph Laplacian (the matrix class the
reference's MFEM loader exists for, reference utils.rs:269-350).

Builds ``unstructured_poisson_2d(side)`` (jittered grid, random
renumbering, Delaunay, RCM; side² dofs) or with ``--dim 3``
``unstructured_poisson_3d(side)``, runs the SA setup with the JAX
tool's config (:func:`tpu_amg_torch.solver.unstructured_config`: cd 8 /
2, one smoothing step, 10 smoothing iterations, coarsest 1500, float32,
dense at ≤ 8192 rows), prints each level's format, and times:

- one V-cycle, float32 and ``"bf16_values"`` (CUDA events over the
  replay of a CUDA graph of ``--reps`` cycles, median of 5);
- the PCG solve of b = A·x_true (x_true standard normal, seed 3) to
  rtol 1e-6, at most 200 iterations, with each cycle: a first solve,
  then the best of 3 (``AMGSolver.solve``: a CUDA graph an iteration).

Prints one JSON line with the JAX tool's keys.  ``--ckpt PATH`` loads
the hierarchy from PATH when it exists (``setup_s`` is then the load's
seconds) and otherwise saves it there after the setup.  On the CPU
(``--device cpu``) every time is the host clock's, a CPU number.

Usage: python -m tpu_amg_torch.tools.bench_unstructured [--side 512] [--dim 3] [--ckpt H.npz] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

RTOL = 1e-6
MAXITER = 200
X_TRUE_SEED = 3


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def problem(side: int, dim: int):
    from tpu_amg_torch.utils.problems import (
        unstructured_poisson_2d,
        unstructured_poisson_3d,
    )

    return (unstructured_poisson_3d(side) if dim == 3
            else unstructured_poisson_2d(side))


def setup_or_load(a, device, ckpt=None):
    """(solver, seconds): the SA setup with :func:`unstructured_config`,
    or its load from ``ckpt`` when that file exists (saved there after a
    setup when it does not)."""
    from tpu_amg_torch.solver import AMGSolver, unstructured_config

    cfg = unstructured_config(str(device))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    if ckpt and os.path.exists(ckpt):
        solver = AMGSolver.load(ckpt, a, cfg)
    else:
        solver = AMGSolver.setup(a, cfg)
    sync()
    seconds = time.perf_counter() - t0
    if ckpt and not os.path.exists(ckpt):
        solver.save(ckpt)
    return solver, seconds


def run(argv=None) -> dict:
    """The command line's work: returns {"json": the printed line's
    object, "solver", "a", "solves": {"f32", "bf16_values"},
    "op_complexity"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=None,
                    help="grid side (side^dim dofs); defaults: dim 2 -> "
                         "512 on the card / 64 on the CPU, dim 3 -> 101 / 12")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.precision import cast_preconditioner
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.tools.vcycle_breakdown import level_format
    from tpu_amg_torch.utils.timing import call_ms, solve_best

    device = resolve_device(args.device)
    card = device.type == "cuda"
    if args.dim == 3:
        side = args.side or (101 if card else 12)
    else:
        side = args.side or (512 if card else 64)
    reps = args.reps or (200 if card else 3)

    t0 = time.perf_counter()
    a = problem(side, args.dim)
    say(f"# unstructured n={a.nrows} nnz={a.nnz} "
        f"(built {time.perf_counter() - t0:.1f}s)")
    solver, t_setup = setup_or_load(a, device, args.ckpt)
    mg = solver.preconditioner
    oc = solver.hierarchy.op_complexity()
    say(f"# setup {t_setup:.1f}s, op complexity {oc:.2f}")
    for i, lvl in enumerate(mg.levels):
        say(f"# level {i}: n={lvl.a.shape[0]} fmt={level_format(lvl.a)}")

    x = torch.ones(a.nrows, dtype=torch.float32, device=device)
    dt_f32 = call_ms(lambda: mg.mv(x), device, reps)
    say(f"# vcycle[f32]={dt_f32:.3f}ms")
    mg16 = cast_preconditioner(mg, "bf16_values")
    dt_16 = call_ms(lambda: mg16.mv(x), device, reps)
    say(f"# vcycle[bf16_values]={dt_16:.3f}ms")

    # manufactured rhs: the raw Laplacian is singular up to its 1e-8
    # shift, so b = A x_true keeps the solution representable in f32
    x_true = torch.from_numpy(
        np.random.default_rng(X_TRUE_SEED).normal(size=a.nrows)
    ).to(device, torch.float32)
    b = solver.op.mv(x_true)
    solves = {}
    for name, m in (("f32", mg), ("bf16_values", mg16)):
        solves[name] = solve_best(
            AMGSolver(solver.matrix, m, config=solver.config, op=solver.op),
            b, RTOL, MAXITER)
        s = solves[name]
        say(f"# solve[{name}]: {s['s'] * 1e3:.1f}ms, {s['iters']} iters, "
            f"res {s['final_res']:.2e}")
    out = {
        "metric": f"unstructured_fem{args.dim}d_vcycle_{a.nrows}",
        "setup_s": round(t_setup, 1),
        "value": round(dt_f32, 4),
        "unit": "ms",
        "vs_baseline": round(dt_f32 / dt_16, 4),
        "value_bf16_values": round(dt_16, 4),
        "solve_ms_f32": round(solves["f32"]["s"] * 1e3, 2),
        "solve_ms_bf16_values": round(solves["bf16_values"]["s"] * 1e3, 2),
        "iters_f32": solves["f32"]["iters"],
        "iters_bf16_values": solves["bf16_values"]["iters"],
    }
    print(json.dumps(out), flush=True)
    return dict(json=out, solver=solver, a=a, solves=solves,
                op_complexity=oc, x_true=x_true, b=b)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
