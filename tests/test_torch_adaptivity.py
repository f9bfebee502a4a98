"""The adaptive composite against the JAX package: ``Composite``, the
product-form smoothing, ``AdaptiveConfig.build``, rand-SVD and the
multilevel partitioner.

Both packages get the same inputs: the same components, start blocks,
Ω and graphs.  ``AdaptiveConfig.build`` gets the reference's own draws
(the two bootstrap blocks from ``split(k_nn)`` and one enrichment block
a round from ``k_loop, k_iter = split(k_loop)``), so that both build the
same hierarchies: identical partitions, matrices to 1e-10.  Float64 on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_amg import adaptivity as jax_adaptivity
from tpu_amg.adaptivity import AdaptiveConfig as JaxAdaptiveConfig
from tpu_amg.decompositions import rand_svd as jax_rand_svd
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.linop import DenseOperator as JaxDenseOperator
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.partition import MultilevelPartitionerConfig as JaxMultilevel
from tpu_amg.partition import Partition as JaxPartition
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners import Composite as JaxComposite
from tpu_amg.preconditioners import build_smoother as jax_build_smoother
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.utils.problems import anisotropic_diffusion_2d as jax_aniso
from tpu_amg.utils.problems import poisson2d as jax_poisson2d
from tpu_amg_torch.adaptivity import AdaptiveConfig, smooth_vector
from tpu_amg_torch.decompositions import rand_svd, smooth_vector_rand_svd
from tpu_amg_torch.hierarchy import HierarchyConfig
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.linop import DenseOperator, DiagonalOperator, SparseOperator
from tpu_amg_torch.partition import (
    MultilevelPartitionerConfig,
    Partition,
    PartitionerConfig,
)
from tpu_amg_torch.preconditioners import Composite
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.preconditioners.smoothers import (
    ErrorPropagator,
    build_smoother,
    l1_inverse_diag,
)
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d, poisson2d
from tpu_amg_torch.utils.testing import symmetry_test

# the problem and config of tests/test_adaptivity.py::TestAdaptiveBuild
ANISO = dict(epsilon=1e-2, theta=np.pi / 7)
SIDE = 12


def _vec(n, k=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


# (name, keyword arguments): the smoothers that serve as the components of
# tests/test_adaptivity.py::TestComposite
SMOOTHERS = (("l1", {}), ("jacobi", {"omega": 0.5}), ("l2", {}))


def _components(count):
    a = poisson2d(6)
    ref_op = jax_aslinearoperator(jax_poisson2d(6))
    op = SparseOperator.from_csr(a, "cpu")
    got = tuple(build_smoother(kind, a, "cpu", **kw)
                for kind, kw in SMOOTHERS[:count])
    ref = tuple(jax_build_smoother(kind, ref_op.ell, **kw)
                for kind, kw in SMOOTHERS[:count])
    return (Composite(a=op, components=got),
            JaxComposite(a=ref_op, components=ref))


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("k", [None, 3])
def test_composite_matches_jax(count, k):
    comp, ref = _components(count)
    x = _vec(36, k, seed=count)
    _close(comp(torch.from_numpy(x)), ref(jnp.asarray(x)), 1e-12)


def test_two_components_sweep_order():
    """[M1, M0, M1]: reversed, then forward skipping the first."""
    comp, _ = _components(2)
    m0, m1 = comp.components
    x = torch.from_numpy(_vec(36, seed=1))
    out = torch.zeros(36, dtype=torch.float64)
    ws = x
    for m in (m1, m0, m1):
        out = out + m.mv(ws)
        ws = x - comp.a.mv(out)
    _close(comp.mv(x), out, 1e-12)
    assert comp.sweep() == [m1, m0, m1]
    assert comp.push(m0).components == (m0, m1, m0)


@pytest.mark.parametrize("count", [2, 3])
def test_composite_symmetric(count):
    comp, _ = _components(count)
    assert symmetry_test(comp, rtol=1e-9, device="cpu")


class _Counting(SparseOperator):
    """A sparse operator that counts its applies."""

    applies = 0

    def mv(self, x):
        self.applies += 1
        return super().mv(x)

    def mm(self, xs):
        self.applies += 1
        return super().mm(xs)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_composite_applies_a_2n_minus_2_times(count):
    """No work residual after the last component: 2n − 1 component
    applies and 2n − 2 applies of A."""
    comp, _ = _components(count)
    op = comp.a
    counting = _Counting(mat=op.mat, mat_t=op.mat_t, block_size=op.block_size)
    comp = Composite(a=counting, components=comp.components)
    for k in (None, 2):
        counting.applies = 0
        comp(torch.from_numpy(_vec(36, k)))
        assert counting.applies == 2 * count - 2


@pytest.mark.parametrize("count", [1, 2, 3])
def test_product_form_smoothing_matches_jax(count):
    """smooth_vector through a composite, against the JAX package's
    ``_smooth_loop_composite`` (``_smooth_loop`` for one component) from
    the same start block."""
    comp, ref = _components(count)
    x0 = _vec(36, 4, seed=7)
    basis, cfs = smooth_vector(comp.a, comp, 5, 4, x0=x0, device="cpu")
    ref_basis, ref_cfs = jax_adaptivity._smooth_loop(
        ref.a, ref, jnp.asarray(x0), 5)
    if count > 1:
        ref_basis, ref_cfs = jax_adaptivity._smooth_loop_composite(
            ref.a, ref, jnp.asarray(x0), 5)
    _close(basis, ref_basis, 1e-10)
    _close(cfs, ref_cfs, 1e-10)


# ---- AdaptiveConfig.build


def _adaptive_kwargs(jax_side: bool, max_components: int):
    """tests/test_adaptivity.py::TestAdaptiveBuild's config, in either
    package."""
    if jax_side:
        part, interp = JaxPartitionerConfig, JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                candidate_dimension=2,
                partitioner_config=JaxPartitionerConfig(
                    coarsening_factor=4.0, max_improvement_iters=10),
            ),
        )
        hier = JaxHierarchyConfig(coarsest_dim=30, interpolation_config=interp)
        mg = JaxMultigridConfig
        dev = {}
    else:
        part, interp = PartitionerConfig, InterpolationConfig(
            kind="aggregation",
            aggregation=AggregationConfig(
                candidate_dimension=2,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=4.0, max_improvement_iters=10),
            ),
        )
        hier = HierarchyConfig(coarsest_dim=30, interpolation_config=interp,
                               device="cpu")
        mg = MultigridConfig
        dev = {"device": "cpu"}
    return dict(
        hierarchy_config=hier,
        multigrid_config=mg(
            smoothing_steps=1,
            smoother_partitioner=part(coarsening_factor=16.0,
                                      max_improvement_iters=10),
            **dev,
        ),
        max_components=max_components,
        test_iters=10,
        coarsening_near_null_dim=4,
    )


def reference_draws(key, n, dim, rounds):
    """The JAX ``AdaptiveConfig.build``'s draws from ``key``: the two
    bootstrap blocks (n, dim − 1) and one (n, dim) block a round."""
    k_nn, k_loop = jax.random.split(key)
    k1, k2 = jax.random.split(k_nn)
    starts = tuple(np.asarray(jax.random.normal(k, (n, dim - 1), jnp.float64))
                   for k in (k1, k2))
    blocks = []
    for _ in range(rounds):
        k_loop, k_iter = jax.random.split(k_loop)
        blocks.append(np.asarray(jax.random.normal(k_iter, (n, dim),
                                                   jnp.float64)))
    return starts, blocks


@pytest.fixture(scope="module", params=[2, 3])
def adaptive_pair(request):
    """(JAX composite, its hierarchies, port composite, its hierarchies,
    the port's phase seconds)."""
    count = request.param
    a_ref = jax_aniso(SIDE, **ANISO)
    ref, ref_h = JaxAdaptiveConfig(**_adaptive_kwargs(True, count)).build(
        a_ref, jax.random.PRNGKey(0), return_hierarchies=True)
    starts, blocks = reference_draws(jax.random.PRNGKey(0), a_ref.nrows, 4,
                                     count - 1)
    seconds = {}
    got, got_h = AdaptiveConfig(**_adaptive_kwargs(False, count)).build(
        anisotropic_diffusion_2d(SIDE, **ANISO), near_null_starts=starts,
        enrichment_starts=blocks, return_hierarchies=True, seconds=seconds)
    return ref, ref_h, got, got_h, seconds


def test_adaptive_build_same_hierarchies(adaptive_pair):
    ref, ref_h, got, got_h, seconds = adaptive_pair
    assert len(got.components) == len(ref.components) == len(got_h)
    for hg, hr in zip(got_h, ref_h):
        assert hg.num_levels == hr.num_levels >= 2
        for pg, pr in zip(hg.partitions, hr.partitions):
            np.testing.assert_array_equal(pg.node_to_agg, pr.node_to_agg)
        for mats in ("matrices", "interpolations", "restrictions"):
            for mg_, mr in zip(getattr(hg, mats), getattr(hr, mats)):
                _close(mg_.to_dense(), mr.to_dense(), 1e-10)
        _close(hg.near_nulls[0], hr.near_nulls[0], 1e-10)
    # a later component's weights are the measured convergence factors
    for hg, hr in zip(got_h[1:], ref_h[1:]):
        _close(hg.nn_weights[0], hr.nn_weights[0], 1e-8)
    count = len(got_h)
    assert set(seconds) == (
        {"near_null"} | {f"hierarchy_{c}" for c in range(1, count + 1)}
        | {f"multigrid_{c}" for c in range(1, count + 1)}
        | {f"enrichment_{c}" for c in range(2, count + 1)})


@pytest.mark.parametrize("k", [None, 2])
def test_adaptive_composite_apply_matches_jax(adaptive_pair, k):
    ref, _, got, _, _ = adaptive_pair
    x = _vec(SIDE * SIDE, k, seed=9)
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)), 1e-9)


def test_adaptive_pcg_matches_jax(adaptive_pair):
    ref, _, got, _, _ = adaptive_pair
    b = np.ones(SIDE * SIDE)
    _, ref_info = jax_cg(ref.a, jnp.asarray(b), ref, rtol=1e-10)
    _, info = cg(got.a, torch.from_numpy(b), got, rtol=1e-10)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    np.testing.assert_allclose(info.history(), ref_info.history(), rtol=1e-8)
    # the enrichment pays: the full composite beats its first component
    one = Composite(a=got.a, components=got.components[:1])
    _, info1 = cg(got.a, torch.from_numpy(b), one, rtol=1e-10)
    assert info.iters < info1.iters


def test_adaptive_own_generator_is_repeatable():
    a = anisotropic_diffusion_2d(SIDE, **ANISO)
    cfg = AdaptiveConfig(**_adaptive_kwargs(False, 2))
    x = torch.from_numpy(_vec(a.nrows, seed=2))
    applies = [cfg.build(a, torch.Generator().manual_seed(3))(x)
               for _ in range(2)]
    assert torch.equal(*applies)
    nn_off = AdaptiveConfig(**{**_adaptive_kwargs(False, 2),
                               "include_constant_first_near_null": False})
    assert len(nn_off.build(a).components) == 2


# ---- rand-SVD


def _manufactured(m=200, n=150, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, m)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = np.exp(-0.1 * np.arange(n))
    return u, s, v, (u[:, :n] * s) @ v.T


def test_rand_svd_manufactured_decay():
    """tests/test_adaptivity.py::TestRandSVD: A = U diag(e^{-0.1 i}) Vᵀ
    (200×150), recover k=50."""
    u, s, v, a = _manufactured()
    k = 50
    uu, ss, vv = (t.numpy() for t in rand_svd(
        DenseOperator(mat=torch.from_numpy(a)), k, 10, 2, device="cpu"))
    align_u = np.linalg.norm(u[:, :k].T @ uu) ** 2 / k
    align_v = np.linalg.norm(v[:, :k].T @ vv) ** 2 / k
    sigma_ratio = ss.sum() / s[:k].sum()
    assert align_u > 0.95
    assert align_v > 0.95
    assert 0.97 < sigma_ratio <= 1.001


@pytest.mark.parametrize("subspace_iters", [0, 2])
def test_rand_svd_matches_jax(subspace_iters):
    """The same Ω: JAX's draw from PRNGKey(0), handed to the port."""
    _, _, _, a = _manufactured()
    k, over = 50, 10
    key = jax.random.PRNGKey(0)
    omega = np.asarray(jax.random.normal(key, (a.shape[1], k + over),
                                         jnp.float64))
    _, s_ref, v_ref = jax_rand_svd(JaxDenseOperator(mat=jnp.asarray(a)), key,
                                   k, over, subspace_iters)
    _, s, v = rand_svd(DenseOperator(mat=torch.from_numpy(a)), k, over,
                       subspace_iters, omega=omega, device="cpu")
    _close(s, s_ref, 1e-10)
    # singular vectors up to sign, where σ is well separated
    top = 10
    signs = np.sign(np.sum(v.numpy()[:, :top] * np.asarray(v_ref)[:, :top],
                           axis=0))
    _close(v.numpy()[:, :top] * signs, np.asarray(v_ref)[:, :top], 1e-8)


def test_error_propagator_near_null():
    a = poisson2d(8)
    op = SparseOperator.from_csr(a, "cpu")
    m = DiagonalOperator(diag=torch.from_numpy(l1_inverse_diag(a)))
    e = ErrorPropagator(a=op, m=m, iters=1)
    v = smooth_vector_rand_svd(e, 4, 5, device="cpu").numpy()
    assert v.shape == (64, 4)
    rq = np.einsum("nk,nk->k", v, a.matvec(v)) / np.einsum("nk,nk->k", v, v)
    assert rq.max() < 2.0  # smooth modes of Poisson have small RQ


# ---- partitions


@pytest.mark.parametrize("stages", [2, 3])
def test_multilevel_partition_matches_jax(stages):
    a = anisotropic_diffusion_2d(16, **ANISO)
    a_ref = jax_aniso(16, **ANISO)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), _vec(a.nrows, 2, seed=4)], 1))
    w = np.ones(3)
    got = MultilevelPartitionerConfig.even_stages(
        64.0, stages, max_improvement_iters=20).build_partition(a, nn, w)
    ref = JaxMultilevel.even_stages(
        64.0, stages, max_improvement_iters=20).build_partition(a_ref, nn, w)
    np.testing.assert_array_equal(got.node_to_agg, ref.node_to_agg)
    assert got.num_aggs == ref.num_aggs > 1


def test_partition_compose_and_agg_lists_match_jax():
    rng = np.random.default_rng(5)
    fine = rng.integers(0, 12, 60)
    coarse = rng.integers(0, 4, len(np.unique(fine)))
    got = Partition(fine).compose(Partition(coarse))
    ref = JaxPartition(fine).compose(JaxPartition(coarse))
    np.testing.assert_array_equal(got.node_to_agg, ref.node_to_agg)
    lists = got.agg_lists()
    again = Partition.from_agg_lists(lists, 60)
    np.testing.assert_array_equal(
        again.node_to_agg, JaxPartition.from_agg_lists(lists, 60).node_to_agg)
    np.testing.assert_array_equal(again.node_to_agg, got.node_to_agg)
    with pytest.raises(ValueError, match="compose mismatch"):
        got.compose(Partition(np.arange(got.num_aggs + 1)))
    with pytest.raises(ValueError, match="cover"):
        Partition.from_agg_lists(lists[1:], 60)
