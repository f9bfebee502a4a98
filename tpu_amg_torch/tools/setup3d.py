"""Build and checkpoint a 3-D unstructured SA hierarchy: the port of the
JAX package's ``tools/setup3d.py``.

The system is the 3-D unstructured Poisson of BASELINE configs[2]
(``unstructured_poisson_3d(side)``, side³ dofs) or, with
``--elasticity``, the block-3 truss elasticity on the same tet mesh
(``unstructured_elasticity_3d(side)``, 3·side³ dofs; side 55: 499,125).
The config is the JAX tool's (``solver.scalar_3d_config`` /
``solver.elasticity_3d_config``) in float64; ``--bootstrap-dtype f32``
runs the near-null bootstrap in float32, the JAX tool's accelerator
bootstrap.  Prints the setup's wall seconds by phase, the hierarchy and
its complexities, and saves the checkpoint that ``tools.solve3d``
loads.  Every setup phase is logged on stderr as it ends, so a run cut
by its time limit shows how far it got.

Usage: python -m tpu_amg_torch.tools.setup3d [--elasticity] [--side 101] [--out build/h3d.npz] [--device cuda] [--bootstrap-dtype f64]
"""

import argparse
import logging
import sys
import time

BOOTSTRAP_DTYPES = {"f64": "float64", "f32": "float32"}


def build_problem(side: int, elasticity: bool):
    from tpu_amg_torch.utils.problems import (
        unstructured_elasticity_3d,
        unstructured_poisson_3d,
    )

    return (unstructured_elasticity_3d(side) if elasticity
            else unstructured_poisson_3d(side))


def config(elasticity: bool, device: str, trunc=None, drop: float = 0.01,
           **overrides):
    """The JAX tool's config: P truncation ``trunc`` (default 0.1 scalar,
    0.05 elasticity; 0 disables), coarse drop ``drop`` (0 disables)."""
    from tpu_amg_torch.solver import elasticity_3d_config, scalar_3d_config

    trunc = trunc if trunc is not None else (0.05 if elasticity else 0.1)
    make = elasticity_3d_config if elasticity else scalar_3d_config
    return make(device, sa_trunc_tol=trunc or None,
                coarse_drop_tol=drop or None, **overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=101)
    ap.add_argument("--out", type=str, default="build/h3d.npz")
    ap.add_argument("--elasticity", action="store_true",
                    help="block-3 truss elasticity on the tet mesh "
                         "instead of scalar Poisson")
    ap.add_argument("--trunc", type=float, default=None,
                    help="P truncation tol (default 0.1 scalar / "
                         "0.05 elasticity; 0 disables)")
    ap.add_argument("--drop", type=float, default=0.01,
                    help="non-Galerkin coarse sparsification tol "
                         "(0 disables)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--bootstrap-dtype", choices=sorted(BOOTSTRAP_DTYPES),
                    default="f64",
                    help="the near-null bootstrap's smoothing dtype")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(relativeCreated)8.0fms %(name)s %(message)s")

    import torch

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.solver import AMGSolver

    resolve_device(args.device)  # before the system: no card, no build
    t0 = time.perf_counter()
    a = build_problem(args.side, args.elasticity)
    print(f"# system n={a.nrows} nnz={a.nnz} block={a.block_size} "
          f"built {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    cfg = config(args.elasticity, args.device, args.trunc, args.drop,
                 bootstrap_dtype=getattr(
                     torch, BOOTSTRAP_DTYPES[args.bootstrap_dtype]))
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, cfg)
    t_setup = time.perf_counter() - t0
    h = solver.hierarchy
    print(f"# setup {t_setup:.1f}s (" + " ".join(
        f"{k} {v:.1f}s" for k, v in solver.setup_seconds.items())
        + f"; bootstrap {args.bootstrap_dtype}) op_cplx "
        f"{h.op_complexity():.2f} grid_cplx {h.grid_complexity():.2f}",
        file=sys.stderr, flush=True)
    print(repr(h), file=sys.stderr, flush=True)
    solver.save(args.out)
    print(f"# hierarchy checkpoint -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
