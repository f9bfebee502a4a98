"""1-D Poisson geometric-multigrid refinement study: the port of the
JAX package's ``examples/simple_geometric.py``.

Equivalent of reference examples/simple_geometric.rs:176-301: hand-built
finite-difference matrices, linear-interpolation P (½[1 2 1]) and
full-weighting R (¼[1 2 1]), Jacobi(0.66) smoothing, Cholesky coarsest;
compares PCG+Jacobi vs PCG+MG vs stationary+MG across refinements and
prints the mesh-independence table (the canonical multigrid correctness
oracle, SURVEY.md §4.1).  Nothing in it is random, so its iteration
counts are the JAX package's.

Usage: python -m tpu_amg_torch.tools.simple_geometric [--device cpu] [--max-refine 10]
"""

import argparse

import torch


def refinement_rows(refinements, coarse_elements: int, tol: float, device):
    """(refinements, dofs, PCG+Jacobi, PCG+MG, stationary+MG iterations)
    for each refinement count, printing one line each."""
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.preconditioners.smoothers import build_smoother
    from tpu_amg_torch.solvers import cg, stationary_iteration
    from tpu_amg_torch.utils.geometric import build_geometric_mg

    rows = []
    for r in refinements:
        fine, mg = build_geometric_mg(r, coarse_elements=coarse_elements,
                                      device=device)
        a = SparseOperator.from_csr(fine, device, torch.float64)
        b = torch.ones(fine.nrows, dtype=torch.float64, device=device)
        jac = build_smoother("jacobi", fine, device, torch.float64,
                             omega=0.66)
        _, pcg_jac = cg(a, b, jac, rtol=tol, maxiter=20000)
        _, pcg_mg = cg(a, b, mg, rtol=tol, maxiter=1000)
        _, sli_mg = stationary_iteration(a, b, mg, rtol=tol, maxiter=1000)
        rows.append((r, fine.nrows, pcg_jac.iters, pcg_mg.iters,
                     sli_mg.iters))
        print(
            f"refine={r:2d} dofs={fine.nrows:6d} "
            f"pcg+jacobi={pcg_jac.iters:5d} "
            f"pcg+mg={pcg_mg.iters:3d} "
            f"stat+mg={sli_mg.iters:3d}"
        )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--min-refine", type=int, default=2)
    p.add_argument("--max-refine", type=int, default=10)
    p.add_argument("--coarse-elements", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)

    from tpu_amg_torch.device import resolve_device

    rows = refinement_rows(range(args.min_refine, args.max_refine + 1),
                           args.coarse_elements, args.tol,
                           resolve_device(args.device))
    print("\nrefinements  dofs  pcg_jacobi  pcg_mg  stationary_mg")
    for r in rows:
        print(f"{r[0]:>10}  {r[1]:>5}  {r[2]:>9}  {r[3]:>6}  {r[4]:>12}")
    mg_iters = [r[3] for r in rows]
    print(
        f"\nmesh independence: pcg+mg iters "
        f"{mg_iters[0]} -> {mg_iters[-1]} over "
        f"{rows[-1][1] / rows[0][1]:.0f}x dof growth"
    )
    return rows


if __name__ == "__main__":
    main()
