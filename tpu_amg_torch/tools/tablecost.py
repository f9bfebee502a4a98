"""The host cost of K1's and K2's many-column tables inside AMG setups.

``CappedCSR.from_csr`` builds, with every matrix, K1's staged SpMM table
(``spmv.spmm_blocks``) and K2's piece table (``spmv.k2_pieces``).  This
tool runs the setups that build them and prints, for each, its seconds
and the seconds and count of the table builds within it: the SA setup
of ``tools.setup3d`` (``unstructured_poisson_3d(--sa-side)``), the
real-FEM setup of ``chip_smoke.py`` phase 20 (the fixture of
``tools.make_fem_fixture --side --fem-side``, written under
``--fem-dir``, with ``solver.unstructured_config``) and the adaptive
composite of phase 14 (``anisotropic_diffusion_2d(--adaptive-n)``,
``bootstrap_study.adaptive_config``).  The tables are host work;
``--device`` picks where a setup's device work runs.  Run on a tree
without the tables, it prints the setups' seconds and 0 builds.

Usage: python -m tpu_amg_torch.tools.tablecost [--device cuda]
    [--setups sa fem adaptive] [--sa-side 48] [--fem-side 512]
    [--adaptive-n 512] [--fem-dir build/tablecost]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def timed_tables(spmv) -> dict:
    """Wrap the table builders of ``spmv`` (those it has) so that each
    call adds its seconds and one build to the returned dict."""
    spent = dict(seconds=0.0, builds=0)
    for name in ("spmm_blocks", "k2_pieces"):
        build = getattr(spmv, name, None)
        if build is None:
            continue

        def wrapped(*args, _build=build, **kwargs):
            t0 = time.perf_counter()
            out = _build(*args, **kwargs)
            spent["seconds"] += time.perf_counter() - t0
            spent["builds"] += 1
            return out

        setattr(spmv, name, wrapped)
    return spent


def problem(kind: str, args):
    """(matrix, config) of setup ``kind``."""
    if kind == "sa":
        from tpu_amg_torch.tools.setup3d import build_problem, config

        return build_problem(args.sa_side, False), config(False, args.device)
    if kind == "fem":
        from tpu_amg_torch.solver import unstructured_config
        from tpu_amg_torch.utils.io import load_mfem_linear_system

        name = f"fem_square_k100_s{args.fem_side}"
        d = Path(args.fem_dir) / name
        if not (d / f"{name}.mtx").exists():
            subprocess.run([sys.executable, "-m",
                            "tpu_amg_torch.tools.make_fem_fixture", "--side",
                            str(args.fem_side), "--out", str(d)],
                           check=True, capture_output=True)
        return (load_mfem_linear_system(d, name).matrix,
                unstructured_config(args.device))
    from tpu_amg_torch.tools.bootstrap_study import adaptive_config
    from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d

    return (anisotropic_diffusion_2d(args.adaptive_n, epsilon=1e-3,
                                     theta=np.pi / 6, coefficient="random"),
            adaptive_config(args.device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--setups", nargs="+", default=["sa", "fem", "adaptive"],
                    choices=["sa", "fem", "adaptive"])
    ap.add_argument("--sa-side", type=int, default=48)
    ap.add_argument("--fem-side", type=int, default=512)
    ap.add_argument("--adaptive-n", type=int, default=512)
    ap.add_argument("--fem-dir", default="build/tablecost")
    args = ap.parse_args(argv)

    import torch

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.solver import AMGSolver

    resolve_device(args.device)
    spent = timed_tables(spmv)
    for kind in args.setups:
        a, cfg = problem(kind, args)
        before = dict(spent)
        if args.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        AMGSolver.setup(a, cfg)
        if args.device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tables = spent["seconds"] - before["seconds"]
        print(f"{kind}: n={a.nrows} setup {seconds:.2f} s; the tables "
              f"{tables:.2f} s in {spent['builds'] - before['builds']} "
              f"builds ({100 * tables / seconds:.1f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
