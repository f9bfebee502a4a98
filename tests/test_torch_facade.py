"""The solve facade against the JAX package: the stationary solve,
`solve(method=...)`, `compile`, RCM reordering, checkpoint save and load
in both directions, `repr(hierarchy)`, the typed errors, the port's
build sources, and `method="adaptive"` (setup, solve, save and load).

Both packages start from one hierarchy, built by tpu_amg and handed to
the port through a checkpoint file; the Chebyshev power iterations start
from the reference's own draws (tests.test_torch_cycle).  Float64 on
the CPU: histories agree to 1e-10 relative.
"""

import dataclasses
import importlib
import inspect
import pkgutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_amg.errors as jax_errors
from tests.test_reorder import scrambled_poisson
from tests.test_torch_adaptivity import reference_draws
from tests.test_torch_cycle import reference_lambda_starts
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.solver import AMGSolver as JaxSolver
from tpu_amg.solver import SolverConfig as JaxSolverConfig
from tpu_amg.solvers import stationary_iteration as jax_stationary
from tpu_amg.utils import checkpoint as jax_checkpoint
from tpu_amg.utils import reorder as jax_reorder
from tpu_amg.utils.problems import anisotropic_diffusion_2d as jax_aniso
from tpu_amg.utils.problems import poisson2d as jax_poisson2d
from tpu_amg_torch import errors
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solver import AMGSolver, SolverConfig
from tpu_amg_torch.solvers import cg, stationary_iteration
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.utils import checkpoint, reorder, stats
from tpu_amg_torch.preconditioners import Composite
from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d, poisson2d

RTOL = 1e-10
ROOT = Path(__file__).resolve().parents[1]
KW = dict(smoother="chebyshev", dense_threshold=64)


def _jax_hierarchy(side=32):
    a = jax_poisson2d(side)
    rng = np.random.default_rng(0)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, 3))], 1))
    return JaxHierarchyConfig(
        coarsest_dim=30,
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                candidate_dimension=2,
                partitioner_config=JaxPartitionerConfig(coarsening_factor=8.0),
            ),
        ),
    ).build(a, nn)


@pytest.fixture(scope="module")
def from_jax(tmp_path_factory):
    """(the JAX hierarchy, its archive, the port's load of it)."""
    ref = _jax_hierarchy()
    path = tmp_path_factory.mktemp("ckpt") / "jax.npz"
    jax_checkpoint.save_hierarchy(path, ref)
    assert ref.num_levels >= 3
    return ref, path, checkpoint.load_hierarchy(path)


def _assert_same_hierarchy(got, want):
    assert got.num_levels == want.num_levels
    assert got.partition_kinds == want.partition_kinds
    assert got.config.coarsest_dim == want.config.coarsest_dim
    assert got.config.max_levels == want.config.max_levels
    for lists in ("matrices", "interpolations", "restrictions"):
        for m, w in zip(getattr(got, lists), getattr(want, lists)):
            assert m.shape == w.shape and m.block_size == w.block_size
            for field in ("data", "indices", "indptr"):
                np.testing.assert_array_equal(getattr(m, field),
                                              getattr(w, field))
    for lists in ("near_nulls", "nn_weights"):
        for m, w in zip(getattr(got, lists), getattr(want, lists)):
            np.testing.assert_array_equal(m, w)
    for p, q in zip(got.partitions, want.partitions):
        np.testing.assert_array_equal(p.node_to_agg, q.node_to_agg)


def test_jax_archive_loads_in_port(from_jax):
    ref, _, got = from_jax
    _assert_same_hierarchy(got, ref)


def test_port_archive_loads_in_jax(from_jax, tmp_path):
    ref, _, got = from_jax
    path = tmp_path / "port.npz"
    checkpoint.save_hierarchy(path, got)
    _assert_same_hierarchy(jax_checkpoint.load_hierarchy(path), ref)
    _assert_same_hierarchy(checkpoint.load_hierarchy(path), got)


def test_repr_is_the_jax_table(from_jax):
    ref, _, got = from_jax
    assert repr(got) == repr(ref)
    assert stats.format_stats_table(
        [stats.matrix_stats(m) for m in got.matrices]) in repr(got)


def test_mats_are_equal(from_jax):
    _, _, h = from_jax
    a = h.matrices[0]
    assert stats.mats_are_equal(a, a.transpose())
    bumped = dataclasses.replace(a, data=a.data * (1 + 1e-6))
    assert not stats.mats_are_equal(a, bumped)
    assert not stats.mats_are_equal(a, h.matrices[1])


@pytest.fixture(scope="module")
def multigrids(from_jax):
    ref_h, _, h = from_jax
    jax_cfg = JaxMultigridConfig(**KW)
    ref = jax_cfg.build(ref_h)
    got = MultigridConfig(device="cpu", **KW).build(
        h, lambda_starts=reference_lambda_starts(jax_cfg, ref_h))
    return ref, got


def test_stationary_matches_jax(from_jax, multigrids):
    ref_h, _, h = from_jax
    ref_mg, mg = multigrids
    rng = np.random.default_rng(3)
    b, x0 = rng.standard_normal((2, h.matrices[0].nrows))
    x_ref, ref_info = jax_stationary(
        jax_aslinearoperator(ref_h.matrices[0]), jnp.asarray(b), ref_mg,
        jnp.asarray(x0), rtol=1e-8, maxiter=200)
    x, info = stationary_iteration(
        SparseOperator.from_csr(h.matrices[0], "cpu"), torch.from_numpy(b),
        mg, torch.from_numpy(x0), rtol=1e-8, maxiter=200)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters) > 3
    assert len(info.history()) == info.iters + 1
    # each entry is ‖b − A x‖ recomputed, exact to about eps·‖A‖‖x‖ in
    # either package: 1e-10 relative to ‖r₀‖, not to a late, small entry
    hist, ref_hist = info.history(), ref_info.history()
    np.testing.assert_allclose(hist, ref_hist, rtol=RTOL,
                               atol=RTOL * ref_hist[0])
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                               atol=RTOL * np.abs(np.asarray(x_ref)).max())


def test_stationary_stops_at_maxiter(from_jax, multigrids):
    _, _, h = from_jax
    _, mg = multigrids
    b = torch.ones(h.matrices[0].nrows, dtype=torch.float64)
    _, info = stationary_iteration(
        SparseOperator.from_csr(h.matrices[0], "cpu"), b, mg, rtol=1e-30,
        maxiter=4)
    assert info.iters == 4 and not info.converged
    assert len(info.history()) == 5


def _solver_from_archive(path, a):
    return AMGSolver.load(path, a, SolverConfig(device="cpu", **KW))


@pytest.mark.parametrize("method,eager", [("cg", cg),
                                           ("stationary", stationary_iteration)])
def test_solve_method_is_its_eager_solve(from_jax, method, eager):
    ref_h, path, h = from_jax
    solver = _solver_from_archive(path, h.matrices[0])
    b = np.random.default_rng(4).standard_normal(h.matrices[0].nrows)
    x, info = solver.solve(b, rtol=1e-8, maxiter=300, method=method)
    x_d, info_d = eager(solver.op, torch.from_numpy(b), solver.preconditioner,
                         rtol=1e-8, maxiter=300)
    assert info.converged and info.iters == info_d.iters
    assert info.history().tolist() == info_d.history().tolist()
    assert torch.equal(x, x_d)


def test_compile_is_cached_per_key(from_jax):
    _, path, h = from_jax
    solver = _solver_from_archive(path, h.matrices[0])
    fn = solver.compile(rtol=1e-6, maxiter=50, method="stationary")
    assert solver.compile(rtol=1e-6, maxiter=50, method="stationary") is fn
    assert solver.compile(rtol=1e-6, maxiter=50) is not fn
    with pytest.raises(ValueError, match="method"):
        solver.compile(method="jacobi")
    with pytest.raises(ValueError, match="method"):
        solver.solve(np.ones(h.matrices[0].nrows), method="gmres")


def test_save_round_trip(from_jax, tmp_path):
    _, path, h = from_jax
    solver = _solver_from_archive(path, h.matrices[0])
    solver.save(tmp_path / "again.npz")
    again = _solver_from_archive(tmp_path / "again.npz", h.matrices[0])
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(
        h.matrices[0].nrows))
    assert torch.equal(again.apply_preconditioner(r),
                       solver.apply_preconditioner(r))
    solver.hierarchy = None  # neither a hierarchy nor a composite's
    with pytest.raises(ValueError, match="neither"):
        solver.save(tmp_path / "none.npz")


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_matches_jax(seed):
    scrambled, _ = scrambled_poisson(12, seed=seed)
    mine = CSR(scrambled.data, scrambled.indices, scrambled.indptr,
               scrambled.shape)
    perm = reorder.rcm_permutation(mine)
    np.testing.assert_array_equal(perm, jax_reorder.rcm_permutation(scrambled))
    got, p, inv = reorder.rcm_reorder(mine)
    want, _, _ = jax_reorder.rcm_reorder(scrambled)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(inv[p], np.arange(len(p)))
    assert reorder.bandwidth(got) == jax_reorder.bandwidth(want)
    blocked = mine.with_block_size(2)
    np.testing.assert_array_equal(
        reorder.block_rcm_permutation(blocked),
        jax_reorder.block_rcm_permutation(scrambled.with_block_size(2)))
    for fn in ("permute_rows", "permute_cols"):
        np.testing.assert_array_equal(
            getattr(reorder, fn)(mine, perm).to_dense(),
            getattr(jax_reorder, fn)(scrambled, perm).to_dense())


def test_reorder_option_solves_scrambled_system():
    scrambled, _ = scrambled_poisson(12, seed=5)
    a = CSR(scrambled.data, scrambled.indices, scrambled.indptr,
            scrambled.shape)
    cfg = SolverConfig(
        reorder=True, coarsening_near_null_dim=4, interp_near_null_dim=1,
        smoothing_iters=8, coarsest_dim=40, aggregation_iters=10,
        coarsening_factor=8.0, device="cpu",
    )
    s = AMGSolver.setup(a, cfg)
    assert reorder.bandwidth(s.matrix) < reorder.bandwidth(a)
    x0 = np.random.default_rng(6).standard_normal(a.nrows)
    for method in ("cg", "stationary"):
        x, info = s.solve(np.ones(a.nrows), x0, rtol=1e-10, maxiter=400,
                          method=method)
        assert info.converged
        # the solution is in the ORIGINAL numbering
        np.testing.assert_allclose(a.matvec(x.numpy()), np.ones(a.nrows),
                                   atol=1e-7)


# ---- errors: the same types, raised where the JAX package raises them


@pytest.mark.parametrize("name", [n for n, c in vars(jax_errors).items()
                                  if isinstance(c, type)
                                  and issubclass(c, Exception)])
def test_error_types_mirror_jax(name):
    mine, ref = getattr(errors, name), getattr(jax_errors, name)
    assert [b.__name__ for b in mine.__mro__] == [
        b.__name__ for b in ref.__mro__]
    assert (inspect.signature(mine.__init__)
            == inspect.signature(ref.__init__))


def test_sparse_format_error():
    indptr = np.array([0, 1, 2])
    with pytest.raises(errors.SparseFormatError, match="indptr length"):
        CSR(np.ones(2), np.array([0, 1]), indptr, (3, 3))
    with pytest.raises(ValueError, match="not divisible"):  # a subclass
        CSR(np.ones(2), np.array([0, 1]), indptr, (2, 2), block_size=3)


def _small_hierarchy():
    a = poisson2d(8)
    nn = np.ones((a.nrows, 1))
    return HierarchyConfig(
        coarsest_dim=8, max_levels=2, device="cpu",
        interpolation_config=InterpolationConfig(
            kind="aggregation",
            aggregation=AggregationConfig(
                candidate_dimension=1,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=8.0, max_improvement_iters=3),
            ),
        ),
    ).build(a, nn, create_weights(a, nn)), a


def _identity_csr(n):
    idx = np.arange(n)
    return CSR.from_coo(idx, idx, np.ones(n), (n, n))


def test_hierarchy_error():
    from tpu_amg_torch.interpolation.sa import GalerkinCoarse

    hier, _ = _small_hierarchy()
    p = hier.interpolations[0]
    bad = GalerkinCoarse(
        interpolation=p, restriction=hier.restrictions[0],
        coarse_mat=_identity_csr(p.ncols + 1),  # wrong coarse dim
        coarse_nn=np.ones((p.ncols + 1, 1)),
        partition=hier.partitions[0], kind=hier.partition_kinds[0],
    )
    with pytest.raises(errors.HierarchyError, match="dimension mismatch"):
        hier.add_level(bad, np.ones((p.ncols + 1, 1)))


def test_multigrid_build_error():
    hier, a = _small_hierarchy()
    hier.restrictions[0] = _identity_csr(a.nrows // 2)
    with pytest.raises(errors.MultigridBuildError, match="assembly mismatch"):
        MultigridConfig(smoother="chebyshev", device="cpu").build(hier)


# ---- the port builds only from its own sources


def test_sources_lie_in_the_port():
    import tpu_amg_torch.ops as ops

    port = ROOT / "tpu_amg_torch"
    sources = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"tpu_amg_torch.ops.{info.name}")
        if hasattr(module, "SOURCE"):
            sources[info.name] = Path(module.SOURCE).resolve()
    assert {"native", "spmv", "dia", "stream", "spmv_stages", "dma",
            "primitives"} <= set(sources)
    for name, source in sources.items():
        assert source.is_file(), name
        assert port in source.parents, (name, source)
        assert (ROOT / "tpu_amg") not in source.parents, (name, source)


# ---- method="adaptive": the composite through the facade

ADAPTIVE = dict(
    method="adaptive", composite_components=2, coarsening_near_null_dim=4,
    interp_near_null_dim=2, coarsening_factor=4.0, aggregation_iters=10,
    smoothing_iters=10, coarsest_dim=30, dense_threshold=50,
)
ANISO_SIDE = 16


@pytest.fixture(scope="module")
def adaptive_solvers():
    """(the JAX solver, the port's from the JAX package's draws, b)."""
    cfg = JaxSolverConfig(**ADAPTIVE)
    ref = JaxSolver.setup(jax_aniso(ANISO_SIDE), cfg)
    hs = ref.component_hierarchies
    starts, blocks = reference_draws(jax.random.PRNGKey(cfg.seed),
                                     hs[0].matrices[0].nrows, 4, len(hs) - 1)
    mg_cfg = JaxSolver._mg_config(cfg)
    lam = [reference_lambda_starts(mg_cfg, h) for h in hs]
    got = AMGSolver.setup(
        anisotropic_diffusion_2d(ANISO_SIDE),
        SolverConfig(device="cpu", **ADAPTIVE), near_null_starts=starts,
        enrichment_starts=blocks, lambda_starts=lam)
    b = np.random.default_rng(8).standard_normal(ANISO_SIDE ** 2)
    return ref, got, b


def test_adaptive_setup_and_solve_match_jax(adaptive_solvers):
    ref, got, b = adaptive_solvers
    assert isinstance(got.preconditioner, Composite)
    assert got.hierarchy is None and ref.hierarchy is None
    assert len(got.component_hierarchies) == 2
    assert got.op is got.preconditioner.a  # A once on the device
    for hg, hr in zip(got.component_hierarchies, ref.component_hierarchies):
        assert [m.shape for m in hg.matrices] == [m.shape for m in hr.matrices]
        for pg, pr in zip(hg.partitions, hr.partitions):
            np.testing.assert_array_equal(pg.node_to_agg, pr.node_to_agg)
    _, ref_info = ref.solve(jnp.asarray(b), rtol=1e-8)
    x, info = got.solve(b, rtol=1e-8)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    np.testing.assert_allclose(info.history(), ref_info.history(), rtol=1e-8)
    assert {"near_null", "hierarchy_1", "multigrid_1", "enrichment_2",
            "hierarchy_2", "multigrid_2"} == set(got.setup_seconds)


def test_adaptive_save_load_round_trip(adaptive_solvers, tmp_path):
    _, got, b = adaptive_solvers
    path = tmp_path / "composite.npz"
    got.save(path)
    cfg = SolverConfig(device="cpu", **ADAPTIVE)
    again = AMGSolver.load(path, got.matrix, cfg)
    assert isinstance(again.preconditioner, Composite)
    assert len(again.preconditioner.components) == 2
    for h, w in zip(again.component_hierarchies, got.component_hierarchies):
        _assert_same_hierarchy(h, w)
    # the Chebyshev starts drawn anew from the same seed: the same bits
    for k in (None, 3):
        r = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (len(b),) if k is None else (len(b), k)))
        fresh = AMGSolver.load(path, got.matrix, cfg)
        assert torch.equal(again.apply_preconditioner(r),
                           fresh.apply_preconditioner(r))
    x, info = again.solve(b, rtol=1e-8)
    assert info.converged
    with pytest.raises(ValueError, match="load_composite_hierarchies"):
        checkpoint.load_hierarchy(path)


def test_adaptive_load_keeps_the_apply_bitwise(adaptive_solvers, tmp_path):
    """A composite saved and loaded with the same Chebyshev starts
    applies bit for bit as the one that was set up."""
    ref, got, b = adaptive_solvers
    path = tmp_path / "composite.npz"
    got.save(path)
    lam = [reference_lambda_starts(JaxSolver._mg_config(ref.config), h)
           for h in ref.component_hierarchies]
    again = AMGSolver.load(path, got.matrix,
                           SolverConfig(device="cpu", **ADAPTIVE),
                           lambda_starts=lam)
    r = torch.from_numpy(b)
    assert torch.equal(again.apply_preconditioner(r),
                       got.apply_preconditioner(r))


@pytest.mark.parametrize("method,error,match", [
    ("smoothed", ValueError, "unknown method"),
])
def test_unported_methods_raise(method, error, match):
    with pytest.raises(error, match=match):
        SolverConfig(method=method, device="cpu")


def test_classical_method_sets_up_and_solves(tmp_path):
    """method="classical": the CR+LS hierarchy, a W-cycle, PCG to 1e-8,
    and the checkpoint's W-cycle after load (tests/test_torch_classical.py
    holds it against the JAX package)."""
    a = poisson2d(24)
    cfg = SolverConfig(device="cpu", method="classical",
                       coarsening_near_null_dim=4, smoothing_iters=5,
                       coarsest_dim=40, dense_threshold=64)
    solver = AMGSolver.setup(a, cfg)
    h = solver.hierarchy
    assert h.num_levels >= 3 and set(h.partition_kinds) == {"classical"}
    assert solver.preconditioner.mu == 2
    b = np.random.default_rng(2).standard_normal(a.nrows)
    x, info = solver.solve(b, rtol=1e-8)
    assert info.converged and info.iters <= 20
    assert (np.linalg.norm(b - a.matvec(x.numpy()))
            <= 1e-8 * np.linalg.norm(b))
    solver.save(tmp_path / "c.npz")
    again = AMGSolver.load(tmp_path / "c.npz", a, cfg)
    assert again.preconditioner.mu == 2
    r = torch.from_numpy(b)
    assert torch.equal(again.apply_preconditioner(r),
                       solver.apply_preconditioner(r))
