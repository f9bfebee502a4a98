"""End-to-end AMG command line: the port of the JAX package's
``examples/amg.py``.

Equivalent of the reference's main program (reference examples/amg/main.rs):
load or generate an SPD system, bootstrap a near-null basis, build the
SA or (``--interpolation classical``) classical CR+LS hierarchy +
multigrid (or the structured multigrid, or with
``--composite N`` the adaptive composite of N multigrids, whose
component-peel study prints a PCG and a stationary table), solve with
PCG and stationary iteration, estimate ‖E‖_A, and print the
machine-readable final line

    cg_iters sli_iters a_norm_of_e op_complexity

(reference examples/amg/main.rs:471-474).  The arguments and the stderr
lines are those of ``examples/amg.py``, with ``--device`` (default
"cuda") in place of its TPU-only ``--host-below``.  Random draws come
from a CPU ``torch.Generator`` seeded with ``--seed``: other numbers than
the JAX package's ``jax.random`` draws from the same seed.

``--precision`` casts the built preconditioner on every path
(:func:`tpu_amg_torch.precision.cast_preconditioner`, after the peel
study of ``--composite``); the outer PCG and the operator stay float64.
``--classical-opts key=val,...`` sets the classical coarsening's knobs
(``tau``, ``search``, ``depth``, ``max``, ``cands``, ``cr_target``,
``relax``; another key exits).  ``--mu`` overrides the cycle index,
whose default is 1 for SA and 2 (a W-cycle) for classical.
``--viz-out PATH`` writes the SA or classical hierarchy's partitions and
first near-null vectors as JSON (:func:`tpu_amg_torch.utils.viz.dump_hierarchy_viz`)
where the JAX CLI does, after the hierarchy is built.  ``--problem elasticity3d`` is the
structured hex-grid elasticity of ``problems.elasticity_3d`` (block
size 3), as in the JAX CLI.

Usage: python -m tpu_amg_torch.tools.amg [--device cpu] [--problem aniso2d] [--n 64] ...
"""

import argparse
import dataclasses
import logging
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", type=str, default=None,
                   help="MFEM system directory (expects <name>.{mtx,bdy,coords,rhs})")
    p.add_argument("--name", type=str, default="system")
    p.add_argument("--problem", type=str, default="aniso2d",
                   choices=["poisson2d", "poisson3d", "aniso2d", "elasticity3d"])
    p.add_argument("--n", type=int, default=64, help="grid points per dim")
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--theta", type=float, default=np.pi / 6)
    p.add_argument("--coefficient", type=str, default="constant")
    p.add_argument("--block-size", type=int, default=1)
    p.add_argument("--coarsening-near-null-dim", type=int, default=64)
    p.add_argument("--interp-near-null-dim", type=int, default=4,
                   help="SA candidate dimension")
    p.add_argument("--smoothing-iters", type=int, default=20)
    p.add_argument("--interpolation", type=str, default="sa",
                   choices=["sa", "classical"])
    p.add_argument("--classical-opts", type=str, default="",
                   help="key=val,... overrides: tau=, search=, depth=, "
                        "max=, cands=, cr_target=, relax= "
                        "(reference examples/amg/main.rs:502-547)")
    p.add_argument("--coarsening-factor", type=float, default=8.0)
    p.add_argument("--sa-filter", type=float, default=None,
                   help="filtered-SA P smoothing threshold theta "
                        "(drops |a_ij| < theta*sqrt(a_ii*a_jj) during "
                        "prolongation smoothing; good for high contrast)")
    p.add_argument("--sa-trunc", type=float, default=None,
                   help="P truncation tolerance (drop |p_ij| < "
                        "tol*rowmax after smoothing, rescale survivors; "
                        "the 3-D fill control)")
    p.add_argument("--aggregation-iters", type=int, default=200,
                   help="partitioner improvement iterations")
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--tol", type=float, default=1e-12)
    p.add_argument("--block-smoother-size", type=float, default=128.0)
    p.add_argument("--coarsest-dim", type=int, default=1000)
    p.add_argument("--max-levels", type=int, default=None)
    p.add_argument("--smoothing-steps", type=int, default=3)
    p.add_argument("--smoother", type=str, default="block",
                   choices=["block", "chebyshev", "l1", "l2", "jacobi"])
    p.add_argument("--chebyshev-degree", type=int, default=3)
    p.add_argument("--mu", type=int, default=None,
                   help="cycle index (default: auto — 1 for SA, 2 for "
                        "classical)")
    p.add_argument("--composite", type=int, default=None,
                   help="adaptive composite with N components")
    p.add_argument("--structured", action="store_true",
                   help="gather-free structured-grid multigrid (tensor-"
                        "grid problems only)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the bootstrap and the solves run: cuda "
                        "(the hand-written kernels) or cpu (their plain "
                        "versions)")
    p.add_argument("--viz-out", type=str, default=None,
                   help="write the hierarchy viz JSON here")
    p.add_argument("--skip-sli", action="store_true",
                   help="skip the stationary-iteration solve (prints -1)")
    p.add_argument("--skip-enorm", action="store_true",
                   help="skip the ||E||_A power estimate (prints nan)")
    p.add_argument("--precision", type=str, default=None,
                   choices=["bf16", "bf16_values", "f32"],
                   help="mixed-precision preconditioner cycle "
                        "(precision.py); outer PCG stays f64")
    p.add_argument("-v", "--verbose", action="store_true")
    return p.parse_args(argv)


def classical_config(opts: str):
    """The classical coarsening's config from ``--classical-opts``
    (``key=val,...``; the mini parser of examples/amg.py, reference
    examples/amg/main.rs:502-547).  An unknown key exits."""
    from tpu_amg_torch.interpolation.classical import (
        ClassicalConfig,
        CompatibleRelaxationConfig,
        LeastSquaresConfig,
    )

    ls_cfg, cr_cfg = LeastSquaresConfig(), CompatibleRelaxationConfig()
    for kv in filter(None, opts.split(",")):
        k, v = kv.split("=")
        if k == "tau":
            ls_cfg.tau_threshold = float(v)
        elif k == "search":
            ls_cfg.search_depth = int(v)
        elif k == "depth":
            ls_cfg.depth_ls = int(v)
        elif k == "max":
            ls_cfg.max_interp = int(v)
        elif k == "cands":
            ls_cfg.max_candidates = int(v)
        elif k == "cr_target":
            cr_cfg.target_convergence = float(v)
        elif k == "relax":
            cr_cfg.relax_steps = int(v)
        else:
            raise SystemExit(f"unknown classical opt {k!r}")
    return ClassicalConfig(cr_options=cr_cfg, ls_options=ls_cfg)


def solver_config(args):
    """The :class:`SolverConfig` of the arguments' setup and multigrid
    knobs, float64: ``AMGSolver.load`` of a checkpoint of the CLI's
    hierarchy with it builds the CLI's own multigrid (the classical
    options live in the hierarchy; ``--chebyshev-degree`` must be its
    default, 3)."""
    from tpu_amg_torch.solver import SolverConfig

    return SolverConfig(
        method="classical" if args.interpolation == "classical" else "sa",
        coarsening_near_null_dim=args.coarsening_near_null_dim,
        interp_near_null_dim=args.interp_near_null_dim,
        sa_filter_theta=args.sa_filter,
        sa_trunc_tol=args.sa_trunc,
        smoothing_iters=args.smoothing_iters,
        coarsening_factor=args.coarsening_factor,
        aggregation_iters=args.aggregation_iters,
        coarsest_dim=args.coarsest_dim,
        max_levels=args.max_levels,
        smoother=args.smoother,
        smoothing_steps=args.smoothing_steps,
        mu=args.mu,
        block_smoother_size=args.block_smoother_size,
        dtype=torch.float64,
        device=args.device,
        seed=args.seed,
    )


def configs(args):
    """(HierarchyConfig, MultigridConfig) of the arguments, as
    examples/amg.py builds them: ``--interpolation`` picks the
    coarsening family (SA, or classical with ``--classical-opts``); the
    multigrid is :func:`solver_config`'s with ``--chebyshev-degree``."""
    from tpu_amg_torch.hierarchy import HierarchyConfig
    from tpu_amg_torch.interpolation import (
        AggregationConfig,
        InterpolationConfig,
    )
    from tpu_amg_torch.partition import PartitionerConfig
    from tpu_amg_torch.solver import AMGSolver

    interp = InterpolationConfig(
        kind="aggregation" if args.interpolation == "sa" else "classical",
        aggregation=AggregationConfig(
            candidate_dimension=args.interp_near_null_dim,
            filter_theta=args.sa_filter,
            trunc_tol=args.sa_trunc,
            partitioner_config=PartitionerConfig(
                coarsening_factor=args.coarsening_factor,
                max_improvement_iters=args.aggregation_iters,
            ),
        ),
        classical=classical_config(args.classical_opts),
    )
    hier_cfg = HierarchyConfig(
        coarsest_dim=args.coarsest_dim,
        interpolation_config=interp,
        max_levels=args.max_levels,
        device=args.device,
    )
    mg_cfg = dataclasses.replace(
        AMGSolver._mg_config(solver_config(args)),
        chebyshev_degree=args.chebyshev_degree,
    )
    return hier_cfg, mg_cfg


def build_hierarchy(a, args, hier_cfg, generator):
    """The CLI's setup of a hierarchy: the near-null bootstrap on
    ``args.device`` (its draws from ``generator``), the QR of [1, basis],
    and the host hierarchy.  Returns (hierarchy, {phase: seconds})."""
    from tpu_amg_torch.adaptivity import find_near_null
    from tpu_amg_torch.hierarchy import create_weights

    t0 = time.perf_counter()
    nn = find_near_null(
        a, args.smoothing_iters, args.coarsening_near_null_dim - 1,
        args.block_smoother_size, args.device, generator=generator,
    )
    basis, _ = np.linalg.qr(
        np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
    )
    t1 = time.perf_counter()
    hierarchy = hier_cfg.build(a, basis, create_weights(a, basis))
    return hierarchy, dict(near_null=t1 - t0,
                           hierarchy=time.perf_counter() - t1)


def load_problem(args):
    from tpu_amg_torch.utils import problems
    from tpu_amg_torch.utils.io import load_mfem_linear_system

    if args.data_dir:
        sys_ = load_mfem_linear_system(args.data_dir, args.name)
        a = sys_.matrix.with_block_size(args.block_size)
        rhs = sys_.rhs[:, 0] if sys_.rhs.size else np.ones(a.nrows)
        return a, rhs
    n = args.n
    if args.problem == "poisson2d":
        a = problems.poisson2d(n)
    elif args.problem == "poisson3d":
        a = problems.poisson3d(n)
    elif args.problem == "elasticity3d":
        a = problems.elasticity_3d(n)
    else:
        a = problems.anisotropic_diffusion_2d(
            n, epsilon=args.epsilon, theta=args.theta,
            coefficient=args.coefficient,
        )
    rhs = np.ones(a.nrows)
    return a, rhs


def test_composite(composite, rhs, x0, max_iters, tol):
    """Peel composite components one by one, re-solving each time
    (reference test_composite, examples/amg/main.rs:589-675): a PCG and
    a stationary row per component count, from all components down to
    one, each (components, iterations, v-cycles, reduction/iter,
    reduction/v-cycle, final rel residual).  Every solve is eager
    (``utils.testing.test_solver``) on the composite's own operator.
    :func:`composite_tables` formats the rows as the JAX package's
    ``test_composite`` returns them."""
    from tpu_amg_torch.utils.testing import test_solver

    def row(count, iters, rel_res):
        vcycles_per_iter = 2 * count - 1
        total = iters * vcycles_per_iter
        red_it = rel_res ** (1.0 / iters) if iters else 0.0
        red_vc = rel_res ** (1.0 / total) if total else 0.0
        return (count, iters, total, red_it, red_vc, rel_res)

    b_norm = float(torch.linalg.vector_norm(rhs))
    pcg_rows, sli_rows = [], []
    while len(composite.components) > 0:
        count = len(composite.components)
        report = test_solver(
            composite.a, composite, rhs, x0, rtol=tol, maxiter=max_iters
        )
        pcg_rows.append(
            row(count, report.cg_iters, report.cg_history[-1] / b_norm)
        )
        sli_rows.append(
            row(count, report.sli_iters, report.sli_history[-1] / b_norm)
        )
        composite = dataclasses.replace(
            composite, components=composite.components[:-1]
        )
    return pcg_rows, sli_rows


def composite_tables(pcg_rows, sli_rows) -> str:
    """The PCG and stationary results tables of the peel study
    (reference build_composite_table, examples/amg/main.rs:677-702)."""

    def table(rows):
        sep = (
            "+------------+------------+------------+----------------------+"
            "----------------------+----------------------+"
        )
        lines = [
            sep,
            "| components | iterations | v-cycles   | reduction/iter       |"
            " reduction/v-cycle    | final rel residual   |",
            sep,
        ]
        for r in rows:
            lines.append(
                f"| {r[0]:>10} | {r[1]:>10} | {r[2]:>10} | {r[3]:>20.3f} |"
                f" {r[4]:>20.3f} | {r[5]:>20.3e} |"
            )
        lines.append(sep)
        return "\n".join(lines)

    return (
        f"Composite PCG results:\n{table(pcg_rows)}\n"
        f"Composite stationary results:\n{table(sli_rows)}"
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    from tpu_amg_torch.adaptivity import AdaptiveConfig
    from tpu_amg_torch.device import disable_tf32, resolve_device
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.utils.testing import (
        approx_convergence_factor,
        test_solver,
    )

    device = resolve_device(args.device)
    disable_tf32()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    a, rhs = load_problem(args)
    print(f"system: n={a.nrows} nnz={a.nnz} block_size={a.block_size}",
          file=sys.stderr)
    generator = torch.Generator().manual_seed(args.seed)
    t_setup = time.time()

    hier_cfg, mg_cfg = configs(args)
    rhs_t = torch.from_numpy(np.asarray(rhs, dtype=np.float64)).to(device)

    if args.structured:
        from tpu_amg_torch.structured import build_structured_multigrid

        if args.data_dir:
            raise SystemExit("--structured requires a tensor-grid problem")
        if args.problem in ("poisson2d", "aniso2d"):
            grid = (args.n, args.n)
        else:
            grid = (args.n,) * 3
        t0 = time.time()
        pc = build_structured_multigrid(
            a, grid, device=device, coarsest_dim=args.coarsest_dim,
            dtype=torch.float64,
        )
        sync()
        op_complexity = float("nan")
        print(f"structured setup: {time.time() - t0:.1f}s", file=sys.stderr)
    elif args.composite:
        cfg = AdaptiveConfig(
            hierarchy_config=hier_cfg,
            multigrid_config=mg_cfg,
            max_components=args.composite,
            test_iters=args.smoothing_iters,
            coarsening_near_null_dim=args.coarsening_near_null_dim,
        )
        pc = cfg.build(a, generator)
        # component-peel study + results tables
        # (reference examples/amg/main.rs:589-675)
        x0 = torch.randn(a.nrows, generator=generator,
                         dtype=torch.float64).to(device)
        print(composite_tables(
            *test_composite(pc, rhs_t, x0, args.max_iters, args.tol)))
        op_complexity = float("nan")  # per-component hierarchies
    else:
        hierarchy, _ = build_hierarchy(a, args, hier_cfg, generator)
        print(repr(hierarchy), file=sys.stderr)
        if args.viz_out:
            from tpu_amg_torch.utils.viz import dump_hierarchy_viz

            dump_hierarchy_viz(hierarchy, args.viz_out)
        pc = mg_cfg.build(hierarchy)
        sync()
        op_complexity = hierarchy.op_complexity()
    # the composite holds A on the device already
    op = (pc.a if args.composite
          else SparseOperator.from_csr(a, device, torch.float64))
    if args.precision:
        from tpu_amg_torch.precision import cast_preconditioner

        pc = cast_preconditioner(pc, args.precision)
    print(f"setup: {time.time() - t_setup:.1f}s", file=sys.stderr)

    t_solve = time.time()
    x0 = torch.randn(a.nrows, generator=generator,
                     dtype=torch.float64).to(device)
    report = test_solver(
        op, pc, rhs_t, x0, rtol=args.tol, maxiter=args.max_iters,
        run_sli=not args.skip_sli,
    )
    print(
        f"solve: {time.time() - t_solve:.1f}s  cg_converged={report.cg_converged} "
        f"sli_converged={report.sli_converged}",
        file=sys.stderr,
    )
    a_norm_e = (float("nan") if args.skip_enorm
                else approx_convergence_factor(op, pc, generator))
    # machine-readable final line (reference examples/amg/main.rs:471-474)
    print(f"{report.cg_iters} {report.sli_iters} {a_norm_e:.6f} "
          f"{op_complexity:.6f}")


if __name__ == "__main__":
    main()
