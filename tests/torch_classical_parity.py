"""The classical hierarchy of both packages on poisson2d(side), from the
same near-null basis.

Usage: JAX_PLATFORMS=cpu python tests/torch_classical_parity.py SIDE

Takes the configuration of ``--interpolation classical --smoother
chebyshev`` (every other option the CLI's default) in both CLIs
(``tpu_amg_torch/tools/amg.py`` and ``examples/amg.py``) and draws two
near-null bases, the port's (its CLI's seeded ``torch.Generator``) and
the JAX package's (its CLI's ``PRNGKey``).  From each basis it builds
both packages' hierarchies and prints their level rows and op
complexity, whether the C-point sets and the patterns of every A, P and
R are equal, the largest relative difference of their values, and each
package's CG iterations (the CLI's protocol: b = 1, a random x0, rtol
1e-8) and ||E||_A.  It tells a difference that comes from the draws from
one that comes from the port.  Not collected by pytest: side 128 takes
about two minutes on the CPU.
"""

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(side: int) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpu_amg.adaptivity import find_near_null as jax_near_null
    from tpu_amg.hierarchy import create_weights as jax_weights
    from tpu_amg.linop import aslinearoperator
    from tpu_amg.utils import problems as jax_problems
    from tpu_amg.utils.testing import approx_convergence_factor as jax_enorm
    from tpu_amg.utils.testing import test_solver as jax_test_solver
    from tpu_amg_torch.adaptivity import find_near_null
    from tpu_amg_torch.hierarchy import create_weights
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.tools import amg
    from tpu_amg_torch.utils import problems
    from tpu_amg_torch.utils.testing import approx_convergence_factor
    from tpu_amg_torch.utils.testing import test_solver

    argv = ["--problem", "poisson2d", "--n", str(side), "--interpolation",
            "classical", "--smoother", "chebyshev"]
    args = amg.parse_args(argv + ["--device", "cpu"])
    a = problems.poisson2d(side)
    hier_cfg, mg_cfg = amg.configs(args)

    # the JAX CLI's configs, from its own parser and builder
    spec = importlib.util.spec_from_file_location(
        "jax_amg_cli", REPO / "examples" / "amg.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    sys.argv = ["amg.py"] + argv
    jargs = jax_cli.parse_args()
    from tpu_amg.hierarchy import HierarchyConfig
    from tpu_amg.interpolation import InterpolationConfig
    from tpu_amg.interpolation.classical import ClassicalConfig
    from tpu_amg.partition import PartitionerConfig
    from tpu_amg.preconditioners.multigrid_builder import MultigridConfig

    aj = jax_problems.poisson2d(side)
    jax_hier_cfg = HierarchyConfig(
        coarsest_dim=jargs.coarsest_dim, max_levels=jargs.max_levels,
        interpolation_config=InterpolationConfig(
            kind="classical", classical=ClassicalConfig()))
    jax_mg_cfg = MultigridConfig(
        mu=jargs.mu, smoothing_steps=jargs.smoothing_steps,
        smoother=jargs.smoother, chebyshev_degree=jargs.chebyshev_degree,
        smoother_partitioner=PartitionerConfig(
            coarsening_factor=jargs.block_smoother_size,
            max_improvement_iters=50))

    def qr_basis(nn):
        return np.linalg.qr(
            np.concatenate([np.ones((a.nrows, 1)), np.asarray(nn)], 1))[0]

    nn_dim = args.coarsening_near_null_dim - 1
    key = jax.random.PRNGKey(jargs.seed)
    k_nn, key = jax.random.split(key)
    bases = {
        "port draws": qr_basis(find_near_null(
            a, args.smoothing_iters, nn_dim, args.block_smoother_size, "cpu",
            generator=torch.Generator().manual_seed(args.seed))),
        "JAX draws": qr_basis(jax_near_null(
            aj, jargs.smoothing_iters, nn_dim, jargs.block_smoother_size,
            k_nn)),
    }
    for label, basis in bases.items():
        t0 = time.perf_counter()
        hp = hier_cfg.build(a, basis, create_weights(a, basis))
        tp = time.perf_counter() - t0
        t0 = time.perf_counter()
        hj = jax_hier_cfg.build(aj, basis, jax_weights(aj, basis))
        tj = time.perf_counter() - t0
        for name, h, secs in (("port", hp, tp), ("JAX", hj, tj)):
            print(f"[{label}] {name}: rows {[m.nrows for m in h.matrices]}, "
                  f"op complexity {h.op_complexity():.6f} ({secs:.1f} s)")
        same_c = all(np.array_equal(p.c_points, q.c_points)
                     for p, q in zip(hp.partitions, hj.partitions))
        same_pattern, diff = True, 0.0
        for lists in ("matrices", "interpolations", "restrictions"):
            for m, w in zip(getattr(hp, lists), getattr(hj, lists)):
                if not (np.array_equal(m.indptr, w.indptr)
                        and np.array_equal(m.indices, w.indices)):
                    same_pattern = False
                    continue
                diff = max(diff, float(np.abs(m.data - w.data).max()
                                       / np.abs(w.data).max()))
        print(f"[{label}] same C-points {same_c}, same patterns "
              f"{same_pattern}, values within {diff:.3e} (relative)")

        op = SparseOperator.from_csr(a, "cpu")
        mg = mg_cfg.build(hp)
        x0 = torch.randn(a.nrows, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(args.seed))
        rep = test_solver(op, mg, torch.ones(a.nrows, dtype=torch.float64),
                          x0, rtol=1e-8, maxiter=200, run_sli=False)
        e_port = approx_convergence_factor(op, mg,
                                           torch.Generator().manual_seed(0))
        jop, jmg = aslinearoperator(aj), jax_mg_cfg.build(hj)
        k_x0, k_e = jax.random.split(key)
        jrep = jax_test_solver(
            jop, jmg, jnp.ones(aj.nrows),
            jax.random.normal(k_x0, (aj.nrows,), dtype=jnp.float64),
            rtol=1e-8, maxiter=200, run_sli=False)
        e_jax = jax_enorm(jop, jmg, k_e)
        print(f"[{label}] port: mu {mg.mu}, CG {rep.cg_iters}, ||E||_A "
              f"{e_port:.6f}; JAX: mu {jmg.mu}, CG {jrep.cg_iters}, "
              f"||E||_A {e_jax:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
