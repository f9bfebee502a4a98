"""Profile the unstructured 2-D algebraic setup: the port of the JAX
package's ``tools/profile_setup.py``.

Runs ``AMGSolver.setup`` under cProfile on ``unstructured_fem_system(
side)`` (side² dofs; 512: 262,144) with the JAX tool's config (cd 8 / 2,
one smoothing step, 10 bootstrap iterations, coarsest 1500, dense
levels at ≤ 8192 rows) in float32, the bootstrap in float32 too (the
JAX run's f32 and its accelerator bootstrap), and prints the top
entries by cumulative and by own time, then the setup's wall seconds
by phase (``AMGSolver.setup_seconds``).

Usage: python -m tpu_amg_torch.tools.profile_setup [--device cpu] [--side 512] [--no-profile] [--top 40]
"""

import argparse
import cProfile
import io
import logging
import pstats
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=None,
                    help="grid side (default: 512 on cuda, 64 on cpu — "
                         "as the JAX tool's TPU and CPU defaults)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(relativeCreated)8.0fms %(name)s %(message)s")

    import torch

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.solver import AMGSolver, SolverConfig
    from tpu_amg_torch.utils.problems import unstructured_fem_system

    device = resolve_device(args.device)
    if args.side is None:
        args.side = 512 if device.type == "cuda" else 64

    t0 = time.perf_counter()
    a = unstructured_fem_system(args.side)
    print(f"# system n={a.nrows} nnz={a.nnz} built "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

    cfg = SolverConfig(
        coarsening_near_null_dim=8,
        interp_near_null_dim=2,
        smoothing_steps=1,
        smoothing_iters=10,
        coarsest_dim=1500,
        dtype=torch.float32,
        bootstrap_dtype=torch.float32,
        dense_threshold=8192,
        device=args.device,
    )

    t0 = time.perf_counter()
    if args.no_profile:
        solver = AMGSolver.setup(a, cfg)
        print(f"# setup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    else:
        pr = cProfile.Profile()
        pr.enable()
        solver = AMGSolver.setup(a, cfg)
        pr.disable()
        print(f"# setup (profiled) {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
        s = io.StringIO()
        ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
        ps.print_stats(args.top)
        ps.sort_stats("tottime").print_stats(args.top)
        print(s.getvalue())
    print("# setup phases: " + " ".join(
        f"{k} {v:.3f}s" for k, v in solver.setup_seconds.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
