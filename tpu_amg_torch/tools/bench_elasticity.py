"""3-D elasticity at scale: the fine level's SpMV by format and a whole
AMG-PCG solve; the port of the JAX package's ``bench_elasticity.py``.

The matrix is ``problems.elasticity_3d(n)`` (structured hex grid,
3·n³ dofs, block size 3) or, with ``--unstructured``,
``unstructured_elasticity_3d(n)`` (the block-RCM ordered truss on a
jittered Delaunay mesh).  The formats are the port's:

- ``csr``: K1 + K2 on a capped CSR;
- ``dia``: K3, where ``try_from_csr(max_diags=200)`` converts the
  matrix (the structured grid only);

each with float64 values and, as ``*_bf16v``, bf16 values under float64
vectors.  Each is timed on the card (CUDA events over a CUDA graph of
``--reps`` calls, median of 5) beside the least time its bytes allow at
the HBM data sheet's rate and the library's SpMV on the same matrix
(``torch.sparse_csr_tensor @ x``: cuSPARSE; timed only here, the port
never calls it).  Then, unless ``--no-solve``, ``AMGSolver.setup`` with
the JAX script's config in float64 and a PCG solve of a seeded random b
to rtol 1e-8 (a CUDA graph an iteration; the second solve is timed),
and the same solve with the cycle cast to ``"bf16_values"``.  The last
line is one JSON object.  On the CPU every time is the host's (plain
versions), not the card's.

Usage: python -m tpu_amg_torch.tools.bench_elasticity [--n 33] [--unstructured] [--no-solve] [--device cuda]
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

RTOL = 1e-8
MAXITER = 300


def csr_bytes(mat, x_itemsize: int) -> int:
    """A capped CSR's y = A x, each input once: values and int32 column
    indices (capped part and tail), int64 row pointers, the tail's row
    table, x and y."""
    vsz = mat.data.element_size()
    nnz = mat.data.numel() + mat.n_tail
    n, m = mat.shape
    return (nnz * (vsz + 4) + 8 * (n + 1) + 4 * (2 * mat.n_tail_rows + 1)
            + (n + m) * x_itemsize)


def dia_bytes(mat, x_itemsize: int) -> int:
    """A DIA matrix's y = A x: its stored diagonals, x and y."""
    return (mat.data.numel() * mat.data.element_size()
            + 2 * mat.shape[0] * x_itemsize)


def formats(a, device) -> dict:
    """name -> (matrix, y = A x function, bytes it must move) for the
    fine matrix ``a``: K1 + K2 on CSR, K3 where ``a`` converts to DIA,
    each with float64 and bf16 values under float64 vectors."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.sparse.dia import try_from_csr

    out = {}
    for suffix, vdt in (("", torch.float64), ("_bf16v", torch.bfloat16)):
        mat = spmv.CappedCSR.from_csr(a, device, vdt)
        out["csr" + suffix] = (mat, spmv.spmv, csr_bytes(mat, 8))
        dia = try_from_csr(a, device, vdt, max_diags=200)
        if dia is not None:
            out["dia" + suffix] = (dia, dia_ops.dia_spmv, dia_bytes(dia, 8))
    return out


def library_csr(a, device):
    """The matrix as a torch sparse CSR tensor (float64, int32 indices):
    ``@ x`` is cuSPARSE's SpMV on the card."""
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int32)),
        torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data), a.shape).to(device)


def solve_config(device: str):
    """The JAX script's solve config (cd 12 / 6, 8 bootstrap iterations,
    cf 16: aggregates of ~6 block nodes), in float64."""
    from tpu_amg_torch.solver import SolverConfig

    return SolverConfig(
        method="sa", interp_near_null_dim=6, coarsening_near_null_dim=12,
        smoothing_iters=8, coarsening_factor=16.0, device=device,
    )


def timed_solve(solver, b):
    """The second of two solves (the first captures the CUDA graph):
    (seconds, SolveInfo)."""
    import torch

    solver.solve(b, rtol=RTOL, maxiter=MAXITER)
    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    _, info = solver.solve(b, rtol=RTOL, maxiter=MAXITER)
    sync()
    return time.perf_counter() - t0, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=33,
                    help="grid points per dim (n^3*3 dofs)")
    ap.add_argument("--unstructured", action="store_true",
                    help="jittered-Delaunay truss elasticity (block-RCM "
                         "ordered; unstructured_elasticity_3d) instead of "
                         "the structured hex grid")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-solve", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.utils.problems import (
        elasticity_3d,
        unstructured_elasticity_3d,
    )
    from tpu_amg_torch.utils.timing import call_ms, hbm_bound_ms

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    a = (unstructured_elasticity_3d(args.n) if args.unstructured
         else elasticity_3d(args.n))
    print(f"# elasticity n={a.nrows} nnz={a.nnz} block={a.block_size} "
          f"(built {time.perf_counter() - t0:.1f}s)", file=sys.stderr,
          flush=True)
    x = torch.ones(a.nrows, dtype=torch.float64, device=device)
    lib = library_csr(a, device)
    lib_ms = call_ms(lambda: lib @ x, device, args.reps)
    where, lib_name = (("card", "cuSPARSE") if device.type == "cuda"
                       else ("host (CPU)", "torch sparse CSR, host"))
    out = {"metric": ("elasticity3d_unstructured_formats" if args.unstructured
                      else "elasticity3d_formats"),
           "n": a.nrows, "nnz": a.nnz,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "library_us": lib_ms * 1e3, "formats": {}}
    for name, (mat, fn, nbytes) in formats(a, device).items():
        ms = call_ms(lambda: fn(mat, x), device, args.reps)
        rec = dict(us=ms * 1e3, bound_us=hbm_bound_ms(nbytes) * 1e3,
                   bytes=nbytes, gnnzs=a.nnz / ms / 1e6)
        out["formats"][name] = rec
        print(f"# {name:9s} {rec['us']:9.2f} us ({where})  bound "
              f"{rec['bound_us']:8.2f} us ({nbytes / 1e6:.1f} MB at the HBM "
              f"data sheet)  library ({lib_name}, f64) {lib_ms * 1e3:8.2f} us  "
              f"{rec['gnnzs']:7.2f} Gnnz/s", file=sys.stderr, flush=True)

    if not args.no_solve:
        cfg = solve_config(args.device)
        t0 = time.perf_counter()
        solver = AMGSolver.setup(a, cfg)
        setup_s = time.perf_counter() - t0
        b = torch.from_numpy(
            np.random.default_rng(42).standard_normal(a.nrows)).to(device)
        solve_s, info = timed_solve(solver, b)
        out.update(setup_s=setup_s, solve_ms=solve_s * 1e3,
                   cg_iters=info.iters, converged=bool(info.converged))
        print(f"# solve: setup {setup_s:.1f}s, solve {solve_s * 1e3:.1f}ms, "
              f"{info.iters} iters, converged={info.converged}",
              file=sys.stderr, flush=True)
        # the bf16-valued cycle under the float64 PCG
        from tpu_amg_torch.precision import cast_preconditioner

        bf16 = AMGSolver(
            a, cast_preconditioner(solver.preconditioner, "bf16_values"),
            hierarchy=solver.hierarchy,
            config=dataclasses.replace(cfg, cycle_precision="bf16_values"),
            op=solver.op)
        solve16_s, info16 = timed_solve(bf16, b)
        out.update(solve_ms_bf16_values=solve16_s * 1e3,
                   cg_iters_bf16_values=info16.iters,
                   converged_bf16_values=bool(info16.converged))
        print(f"# solve[bf16_values]: {solve16_s * 1e3:.1f}ms, "
              f"{info16.iters} iters, converged={info16.converged}",
              file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
