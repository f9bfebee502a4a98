"""Setup parity: the port's host setup against tpu_amg's on the same inputs.

For the same CSR and the same near-null basis (numpy arrays), the port
must give the reference's strength graph, partition (identical
node_to_agg), SA P and R, Galerkin coarse A and whole hierarchy, to
1e-12 (the same float64 host arithmetic; the near-null post-process
runs through the device operators of each package, which sum in another
order).  A checkpoint written by tpu_amg loads in the port unchanged.
"""

import numpy as np
import pytest
import torch

from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.hierarchy import create_weights as jax_create_weights
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.partition import strength_graph as jax_strength_graph
from tpu_amg.utils import problems as jax_problems
from tpu_amg.utils.checkpoint import save_hierarchy
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.partition import PartitionerConfig, strength_graph
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.utils import problems
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays, load_hierarchy

TOL = 1e-12

PROBLEMS = {
    "poisson2d": lambda mod: mod.poisson2d(32),
    "unstructured3d": lambda mod: mod.unstructured_poisson_3d(10),
}


def _pair(name):
    """(reference CSR, port CSR) of one problem, built by each package."""
    return PROBLEMS[name](jax_problems), PROBLEMS[name](problems)


def _basis(n, k=4, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(np.concatenate([np.ones((n, 1)),
                                        rng.standard_normal((n, k - 1))], 1))
    return q


def _assert_csr_close(ref, got, tol=TOL):
    assert ref.shape == got.shape and ref.block_size == got.block_size
    np.testing.assert_array_equal(ref.indptr, got.indptr)
    np.testing.assert_array_equal(ref.indices, got.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=0,
                               atol=tol * np.abs(ref.data).max())


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_problems_identical(name):
    ref, got = _pair(name)
    _assert_csr_close(ref, got, tol=0.0)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_strength_graph(name):
    ref_a, a = _pair(name)
    nn = _basis(a.nrows)
    w = create_weights(a, nn)
    np.testing.assert_allclose(w, jax_create_weights(ref_a, nn), rtol=TOL)
    ref = jax_strength_graph(ref_a, nn, w).adj
    got = strength_graph(a, nn, w).adj
    np.testing.assert_array_equal(ref.indptr, got.indptr)
    np.testing.assert_array_equal(ref.indices, got.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=TOL)


@pytest.mark.parametrize("cf", [8.0, 32.0])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_partition_identical(name, cf):
    ref_a, a = _pair(name)
    nn = _basis(a.nrows)
    w = create_weights(a, nn)
    ref = JaxPartitionerConfig(coarsening_factor=cf).build_partition(ref_a, nn, w)
    got = PartitionerConfig(coarsening_factor=cf).build_partition(a, nn, w)
    np.testing.assert_array_equal(got.node_to_agg, ref.node_to_agg)


@pytest.mark.parametrize("trunc", [None, 0.1])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_sa_transfers_and_galerkin(name, trunc):
    ref_a, a = _pair(name)
    nn = _basis(a.nrows)
    w = create_weights(a, nn)
    kw = dict(candidate_dimension=2, trunc_tol=trunc)
    ref = JaxAggregationConfig(
        partitioner_config=JaxPartitionerConfig(coarsening_factor=16.0), **kw
    ).build(ref_a, nn, w)
    got = AggregationConfig(
        partitioner_config=PartitionerConfig(coarsening_factor=16.0), **kw
    ).build(a, nn, w)
    np.testing.assert_array_equal(got.partition.node_to_agg,
                                  ref.partition.node_to_agg)
    _assert_csr_close(ref.interpolation, got.interpolation)
    _assert_csr_close(ref.restriction, got.restriction)
    _assert_csr_close(ref.coarse_mat, got.coarse_mat)
    np.testing.assert_allclose(np.abs(got.coarse_nn), np.abs(ref.coarse_nn),
                               rtol=0, atol=TOL * np.abs(ref.coarse_nn).max())


def _hierarchies(name, trunc, drop):
    ref_a, a = _pair(name)
    nn = _basis(a.nrows)
    kw = dict(coarsest_dim=40, coarse_drop_tol=drop)
    agg = dict(candidate_dimension=2, trunc_tol=trunc)
    ref = JaxHierarchyConfig(
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                partitioner_config=JaxPartitionerConfig(coarsening_factor=8.0),
                **agg,
            ),
        ),
        **kw,
    ).build(ref_a, nn)
    got = HierarchyConfig(
        interpolation_config=InterpolationConfig(
            aggregation=AggregationConfig(
                partitioner_config=PartitionerConfig(coarsening_factor=8.0),
                **agg,
            ),
        ),
        device="cpu",
        **kw,
    ).build(a, nn)
    return ref, got


@pytest.mark.parametrize("trunc,drop", [(None, None), (0.1, 0.01)])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_hierarchy_build(name, trunc, drop):
    ref, got = _hierarchies(name, trunc, drop)
    assert ref.num_levels == got.num_levels >= 3
    for lvl in range(ref.num_levels):
        _assert_csr_close(ref.matrices[lvl], got.matrices[lvl])
        np.testing.assert_allclose(
            got.near_nulls[lvl], ref.near_nulls[lvl], rtol=0,
            atol=TOL * np.abs(ref.near_nulls[lvl]).max(),
        )
        np.testing.assert_allclose(got.nn_weights[lvl], ref.nn_weights[lvl],
                                   rtol=1e-10)
    for lvl in range(ref.num_levels - 1):
        _assert_csr_close(ref.interpolations[lvl], got.interpolations[lvl])
        _assert_csr_close(ref.restrictions[lvl], got.restrictions[lvl])
        np.testing.assert_array_equal(got.partitions[lvl].node_to_agg,
                                      ref.partitions[lvl].node_to_agg)
    assert got.op_complexity() == pytest.approx(ref.op_complexity(), rel=TOL)


def test_checkpoint_loads_unchanged(tmp_path):
    ref, _ = _hierarchies("poisson2d", 0.1, 0.01)
    path = tmp_path / "h.npz"
    save_hierarchy(path, ref)
    got = load_hierarchy(path)
    assert got.num_levels == ref.num_levels
    assert got.partition_kinds == ref.partition_kinds
    for lvl in range(ref.num_levels):
        _assert_csr_close(ref.matrices[lvl], got.matrices[lvl], tol=0.0)
        np.testing.assert_array_equal(got.near_nulls[lvl], ref.near_nulls[lvl])
        np.testing.assert_array_equal(got.nn_weights[lvl], ref.nn_weights[lvl])
    for lvl in range(ref.num_levels - 1):
        _assert_csr_close(ref.interpolations[lvl], got.interpolations[lvl],
                          tol=0.0)
        _assert_csr_close(ref.restrictions[lvl], got.restrictions[lvl],
                          tol=0.0)
        np.testing.assert_array_equal(got.partitions[lvl].node_to_agg,
                                      ref.partitions[lvl].node_to_agg)
    # the same arrays through the in-memory entry point
    with np.load(path) as z:
        import json

        meta = json.loads(bytes(z["__meta__"]).decode())
        again = hierarchy_from_arrays(dict(z), meta)
    assert again.num_levels == ref.num_levels


def test_solver_load_from_reference_checkpoint(tmp_path):
    from tpu_amg.solver import AMGSolver as JaxSolver
    from tpu_amg.solver import SolverConfig as JaxConfig
    from tpu_amg_torch.solver import AMGSolver, SolverConfig

    kw = dict(coarsening_near_null_dim=4, interp_near_null_dim=2,
              smoothing_iters=5, coarsest_dim=60, smoother="chebyshev")
    ref_a, a = _pair("poisson2d")
    ref = JaxSolver.setup(ref_a, JaxConfig(**kw))
    ref.save(tmp_path / "s.npz")
    solver = AMGSolver.load(tmp_path / "s.npz", a,
                            SolverConfig(device="cpu", **kw))
    assert solver.hierarchy.num_levels == ref.hierarchy.num_levels
    b = np.random.default_rng(0).standard_normal(a.nrows)
    x, info = solver.solve(b, rtol=1e-8)
    assert info.converged and isinstance(x, torch.Tensor)
    res = np.linalg.norm(b - a.to_scipy() @ x.numpy()) / np.linalg.norm(b)
    assert res <= 1e-8
