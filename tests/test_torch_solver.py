"""The whole slice: AMGSolver.setup + solve in both packages.

The config is the scalar 3-D SA config of the on-card smoke run
(chip_smoke.py) at a small size.  With the reference's own random
draws handed to the port (the two near-null start blocks from
``jax.random.split(PRNGKey(seed))`` and the Chebyshev starts from
``PRNGKey(7)``), the two solves take the same iterations and their
residual histories agree to 1e-8 relative.  With the port's own
``torch.Generator`` both converge within 2 iterations of each other.
On the reference's hierarchy, loaded by the port, the two ‖E‖_A
estimates agree to rounding.
The right-hand side is b = A x_true for a seeded x_true, as in the
reference's own measurement (tools/solve3d.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.solver import AMGSolver as JaxSolver
from tpu_amg.solver import SolverConfig as JaxConfig
from tpu_amg.utils import testing as jax_testing
from tpu_amg.utils.checkpoint import _pack_hierarchy
from tpu_amg.utils.problems import unstructured_poisson_3d as jax_problem
from tests.test_torch_cycle import reference_lambda_starts
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.solver import AMGSolver, SolverConfig
from tpu_amg_torch.utils import testing
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays
from tpu_amg_torch.utils.problems import unstructured_poisson_3d

SIDE = 11
RTOL = 1e-6
CONFIG = dict(
    coarsening_near_null_dim=8, interp_near_null_dim=2,
    coarsening_factor=16.0, smoothing_steps=1, smoothing_iters=10,
    coarsest_dim=40, dense_threshold=50, sa_trunc_tol=0.1,
    coarse_drop_tol=0.01,
)


@pytest.fixture(scope="module")
def reference():
    a = jax_problem(SIDE)
    cfg = JaxConfig(**CONFIG)
    solver = JaxSolver.setup(a, cfg)
    # b = A x_true, as the reference's own measurement (tools/solve3d.py)
    b = a.to_scipy() @ np.random.default_rng(5).standard_normal(a.nrows)
    _, info = solver.solve(jnp.asarray(b), rtol=RTOL)
    return cfg, solver, b, info


def _reference_draws(cfg, solver):
    """The reference's random draws, in the port's numbering."""
    n, k = solver.hierarchy.matrices[0].nrows, cfg.coarsening_near_null_dim - 1
    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    starts = tuple(np.asarray(jax.random.normal(key, (n, k), jnp.float64))
                   for key in (k1, k2))
    lam = reference_lambda_starts(JaxSolver._mg_config(cfg), solver.hierarchy)
    return starts, lam


def test_same_draws_same_solve(reference):
    cfg, ref, b, ref_info = reference
    starts, lam = _reference_draws(cfg, ref)
    solver = AMGSolver.setup(
        unstructured_poisson_3d(SIDE), SolverConfig(device="cpu", **CONFIG),
        near_null_starts=starts, lambda_starts=lam,
    )
    assert solver.hierarchy.num_levels == ref.hierarchy.num_levels >= 3
    for got, want in zip(solver.hierarchy.matrices, ref.hierarchy.matrices):
        assert got.shape == want.shape and got.nnz == want.nnz
    x, info = solver.solve(b, rtol=RTOL)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    hist, ref_hist = info.history(), ref_info.history()
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-8)
    assert set(solver.setup_seconds) == {"near_null", "hierarchy", "multigrid"}


def test_own_generator_converges_alike(reference):
    _, _, b, ref_info = reference
    a = unstructured_poisson_3d(SIDE)
    solver = AMGSolver.setup(a, SolverConfig(device="cpu", **CONFIG))
    x, info = solver.solve(torch.from_numpy(b), rtol=RTOL)
    assert info.converged
    assert abs(info.iters - int(ref_info.iters)) <= 2
    res = np.linalg.norm(b - a.to_scipy() @ x.numpy()) / np.linalg.norm(b)
    assert res <= RTOL
    # the default generator is seeded from config.seed: setup repeats
    again = AMGSolver.setup(a, SolverConfig(device="cpu", **CONFIG))
    _, info2 = again.solve(torch.from_numpy(b), rtol=RTOL)
    np.testing.assert_array_equal(info2.history(), info.history())


# (power steps, tolerance): after 10 steps the estimate is a mixture of
# modes and agrees to 1e-10; by 100 it has settled on the near-constant
# mode (A·1 = 1e-8·1: the graph Laplacian's shift), which E leaves all
# but undamped (‖E‖_A = 1 − 2e-8 in both packages), and whose A-norm
# sums ~15 terms of order 1 to 1e-8: rounding, about 15·eps / 1e-8 ≈
# 2e-7 of it, is all the two packages can agree to there
@pytest.mark.parametrize("num_iters, tol", [(10, 1e-10), (100, 2e-7)])
def test_convergence_factor_matches_jax(reference, num_iters, tol):
    """‖E‖_A of this config's V-cycle (Chebyshev, truncated P, dropped
    coarse entries) in both packages, on the reference's hierarchy and
    its power iteration's start block."""
    cfg, ref, _, _ = reference
    arrays = {}
    meta = _pack_hierarchy(ref.hierarchy, arrays)
    h = hierarchy_from_arrays(arrays, json.loads(json.dumps(meta)))
    _, lam = _reference_draws(cfg, ref)
    mg = AMGSolver._mg_config(SolverConfig(device="cpu", **CONFIG)).build(
        h, lam)
    key = jax.random.PRNGKey(42)
    want = jax_testing.approx_convergence_factor(
        jax_aslinearoperator(ref.hierarchy.matrices[0]), ref.preconditioner,
        key, num_iters=num_iters)
    starts = np.asarray(jax.random.normal(key, (h.matrices[0].nrows, 5),
                                          jnp.float64))
    got = testing.approx_convergence_factor(
        SparseOperator.from_csr(h.matrices[0], "cpu"), mg,
        num_iters=num_iters, starts=starts)
    assert 0.0 < got < 1.0
    assert got == pytest.approx(want, rel=tol)
    if num_iters == 100:
        assert want > 1.0 - 1e-6
