"""The partitioner's metrics, callback, starting partition, rebase and
strict mode, and the multilevel callback, against the JAX package.

Both packages get the same matrix (each its own generator, bit for bit
equal) and one near-null basis made from a seeded numpy draw.  Partitions
and pass indices must be exactly equal; the modularity, edge cost and
size cost after every pass agree to 1e-12 (relative; the sums run over
the same edges in the same order).  Float64 on the CPU.
"""

import numpy as np
import pytest

from tpu_amg import errors as jax_errors
from tpu_amg.hierarchy import create_weights as jax_create_weights
from tpu_amg.partition import MultilevelPartitionerConfig as JaxMultilevel
from tpu_amg.partition import Partition as JaxPartition
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.partition import build_partition as jax_build_partition
from tpu_amg.sparse.csr import CSR as JaxCSR
from tpu_amg.utils import problems as jax_problems
from tpu_amg_torch import errors
from tpu_amg_torch.hierarchy import create_weights
from tpu_amg_torch.partition import (
    MultilevelPartitionerConfig,
    Partition,
    PartitionerConfig,
    build_partition,
)
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.utils import problems

METRIC_RTOL = 1e-12
PROBLEMS = {
    "aniso2d": lambda p: p.anisotropic_diffusion_2d(32),
    "unstructured2d": lambda p: p.unstructured_poisson_2d(32),
}


def _inputs(name, k=4, seed=7):
    """(port matrix, JAX matrix, basis, port weights, JAX weights)."""
    a, ref_a = PROBLEMS[name](problems), PROBLEMS[name](jax_problems)
    np.testing.assert_array_equal(a.data, ref_a.data)
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, k - 1))], 1))
    w, ref_w = create_weights(a, basis), jax_create_weights(ref_a, basis)
    np.testing.assert_array_equal(w, ref_w)
    return a, ref_a, basis, w, ref_w


def _recorder(log):
    def callback(it, part):
        log.append((it, part.partition.node_to_agg.copy(), part.modularity(),
                    part.total_edge_cost(), part.total_agg_size_cost()))
    return callback


def _same_logs(got, ref):
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert len(got) > 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_allclose(g[2:], r[2:], rtol=METRIC_RTOL,
                                   atol=METRIC_RTOL)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_metrics_after_every_pass_match_jax(name):
    a, ref_a, basis, w, ref_w = _inputs(name)
    got, ref = [], []
    part = PartitionerConfig(max_improvement_iters=40,
                             callback=_recorder(got)).build(a, basis, w)
    ref_part = JaxPartitionerConfig(max_improvement_iters=40,
                                    callback=_recorder(ref)).build(
        ref_a, basis, ref_w)
    _same_logs(got, ref)
    np.testing.assert_array_equal(part.partition.node_to_agg,
                                  ref_part.partition.node_to_agg)
    # the final partition's metrics (after the disconnected split)
    np.testing.assert_allclose(
        [part.modularity(), part.total_edge_cost(),
         part.total_agg_size_cost()],
        [ref_part.modularity(), ref_part.total_edge_cost(),
         ref_part.total_agg_size_cost()], rtol=METRIC_RTOL)
    assert 0.0 < part.modularity() < 1.0


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_no_callback_changes_nothing(name):
    a, _, basis, w, _ = _inputs(name)
    plain = PartitionerConfig().build_partition(a, basis, w)
    seen = []
    traced = PartitionerConfig(
        callback=lambda it, p: seen.append(it)).build_partition(a, basis, w)
    np.testing.assert_array_equal(plain.node_to_agg, traced.node_to_agg)
    assert seen == list(range(len(seen))) and seen
    np.testing.assert_array_equal(
        build_partition(a, basis, w, coarsening_factor=6.0).node_to_agg,
        jax_build_partition(PROBLEMS[name](jax_problems), basis, w,
                            coarsening_factor=6.0).node_to_agg)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_starting_partition_matches_jax(name):
    a, ref_a, basis, w, ref_w = _inputs(name)
    # aggregates of 8 random (mostly unconnected) nodes: many moves
    start = np.random.default_rng(3).permutation(a.nrows) // 8
    got, ref = [], []
    part = PartitionerConfig(max_improvement_iters=30,
                             callback=_recorder(got)).build(
        a, basis, w, starting_partition=Partition(start))
    ref_part = JaxPartitionerConfig(max_improvement_iters=30,
                                    callback=_recorder(ref)).build(
        ref_a, basis, ref_w, starting_partition=JaxPartition(start))
    _same_logs(got, ref)
    np.testing.assert_array_equal(part.partition.node_to_agg,
                                  ref_part.partition.node_to_agg)
    np.testing.assert_array_equal(part.row_sums, ref_part.row_sums)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_rebase_matches_jax(name):
    a, ref_a, basis, w, ref_w = _inputs(name)
    cfg = dict(coarsening_factor=4.0, max_improvement_iters=20)
    part = PartitionerConfig(**cfg).build(a, basis, w)
    ref_part = JaxPartitionerConfig(**cfg).build(ref_a, basis, ref_w)
    base = part.partition
    part.rebase(base)
    ref_part.rebase(JaxPartition(base.node_to_agg))
    np.testing.assert_array_equal(part.partition.node_to_agg,
                                  ref_part.partition.node_to_agg)
    assert part.partition.num_nodes == base.num_aggs
    composed = base.compose(part.partition)
    assert composed.num_aggs == part.partition.num_aggs < base.num_aggs
    np.testing.assert_allclose(part.modularity(), ref_part.modularity(),
                               rtol=METRIC_RTOL)


def _pairs_matrix(pkg_csr, n=64):
    """Disjoint 2x2 blocks: one matching round pairs every node, then no
    edge is left, so a coarsening factor above 2 stalls."""
    dense = np.kron(np.eye(n // 2), np.array([[2.0, -1.0], [-1.0, 2.0]]))
    return pkg_csr.from_dense(dense)


@pytest.mark.parametrize("strict", [True, False])
def test_strict_stall_matches_jax(strict):
    a, ref_a = _pairs_matrix(CSR), _pairs_matrix(JaxCSR)
    basis = np.ones((a.nrows, 1))
    w = np.ones(1)
    cfg = dict(coarsening_factor=8.0, strict=strict,
               max_improvement_iters=5)
    if strict:
        with pytest.raises(jax_errors.CoarseningStalled) as ref_exc:
            JaxPartitionerConfig(**cfg).build(ref_a, basis, w)
        with pytest.raises(errors.CoarseningStalled) as exc:
            PartitionerConfig(**cfg).build(a, basis, w)
        assert str(exc.value) == str(ref_exc.value)
        assert exc.value.achieved_cf == ref_exc.value.achieved_cf == 2.0
    else:
        got = PartitionerConfig(**cfg).build_partition(a, basis, w)
        ref = JaxPartitionerConfig(**cfg).build_partition(ref_a, basis, w)
        np.testing.assert_array_equal(got.node_to_agg, ref.node_to_agg)
        assert got.num_aggs == a.nrows // 2


@pytest.mark.parametrize("stages", [2, 3])
def test_multilevel_callback_stages_match_jax(stages):
    a, ref_a, basis, w, ref_w = _inputs("aniso2d")
    got, ref = [], []
    part = MultilevelPartitionerConfig.even_stages(
        64.0, stages, max_improvement_iters=20).build_partition(
        a, basis, w, callback=lambda s, p: got.append((s, p.node_to_agg)))
    ref_part = JaxMultilevel.even_stages(
        64.0, stages, max_improvement_iters=20).build_partition(
        ref_a, basis, ref_w,
        callback=lambda s, p: ref.append((s, p.node_to_agg)))
    assert [s for s, _ in got] == [s for s, _ in ref] == list(range(stages))
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[-1][1], part.node_to_agg)
    np.testing.assert_array_equal(part.node_to_agg, ref_part.node_to_agg)
