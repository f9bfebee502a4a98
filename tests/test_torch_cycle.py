"""Solve-phase parity: smoothers, coarse solve, V-cycle and PCG.

Both packages build from the same hierarchy (built by tpu_amg, loaded
by the port through the checkpoint arrays).  The Chebyshev power
iteration starts from the reference's own draw,
``jax.random.normal(PRNGKey(7), (n,))``, handed to the port as numpy
(mapped through the reference's per-level RCM permutation, which the
port does not apply: a similarity changes no iterate).  Float64 on the
CPU: the results agree to 1e-10 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg import linop as jax_linop
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.ops import qr as jax_qr
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners.block_smoother import BlockSmoother as JaxBlockSmoother
from tpu_amg.preconditioners.chebyshev import ChebyshevSmoother as JaxChebyshev
from tpu_amg.preconditioners import smoothers as jax_smoothers
from tpu_amg.preconditioners.coarse import DenseCholeskySolver as JaxCholesky
from tpu_amg.preconditioners.coarse import DensePinvSolver as JaxPinv
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.sparse.dia import DIA as JaxDIA
from tpu_amg.utils.checkpoint import _pack_hierarchy
from tpu_amg.utils.problems import poisson2d
from tpu_amg_torch import linop
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.ops import qr
from tpu_amg_torch.preconditioners import smoothers
from tpu_amg_torch.preconditioners.block_smoother import BlockSmoother
from tpu_amg_torch.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg_torch.preconditioners.coarse import DenseCholeskySolver, DensePinvSolver
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays

RTOL = 1e-10
DENSE = 64  # dense levels at or under 64 rows: the fine and mid levels stay sparse


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def hierarchies():
    a = poisson2d(32)
    rng = np.random.default_rng(0)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, 3))], 1))
    ref = JaxHierarchyConfig(
        coarsest_dim=30,
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                candidate_dimension=2,
                partitioner_config=JaxPartitionerConfig(coarsening_factor=8.0),
            ),
        ),
    ).build(a, nn)
    arrays = {}
    meta = _pack_hierarchy(ref, arrays)
    got = hierarchy_from_arrays(arrays, json.loads(json.dumps(meta)))
    assert ref.num_levels >= 3
    return ref, got


def reference_lambda_starts(jax_cfg, ref):
    """The reference's λ_max start vector per level, in the port's
    (unpermuted) numbering: the reference's builder RCM-permutes some
    levels, and u[perm] = v maps its start v back."""
    perms = jax_cfg._level_perms(ref)
    starts = []
    for lvl in range(ref.num_levels - 1):
        v = np.asarray(jax.random.normal(
            jax.random.PRNGKey(7), (ref.matrices[lvl].nrows,), jnp.float64))
        if perms[lvl] is not None:
            u = np.empty_like(v)
            u[perms[lvl]] = v
            v = u
        starts.append(v)
    return starts


def _rhs(n, k=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


@pytest.mark.parametrize("k", [None, 4])
def test_block_smoother(hierarchies, k):
    ref_h, h = hierarchies
    a, part = ref_h.matrices[0], ref_h.partitions[0]
    ref = JaxBlockSmoother.build(a, part)
    got = BlockSmoother.build(h.matrices[0], h.partitions[0], "cpu")
    x = _rhs(a.nrows, k)
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("k", [None, 3])
def test_chebyshev(hierarchies, k):
    ref_h, h = hierarchies
    a_ref = ref_h.matrices[0]
    op_ref = jax_aslinearoperator(a_ref)
    d_ref = jnp.asarray(1.0 / a_ref.abs_row_sums())
    ref = JaxChebyshev.build(op_ref, d_ref)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (a_ref.nrows,),
                                      jnp.float64))
    a = h.matrices[0]
    got = ChebyshevSmoother.build(SparseOperator.from_csr(a, "cpu"),
                                  torch.from_numpy(1.0 / a.abs_row_sums()),
                                  v0=v0)
    assert got.lam_max == pytest.approx(float(ref.lam_max), rel=RTOL)
    x = _rhs(a.nrows, k)
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)))


def test_dense_cholesky(hierarchies):
    ref_h, h = hierarchies
    ref = JaxCholesky.build(ref_h.matrices[-1])
    got = DenseCholeskySolver.build(h.matrices[-1], "cpu")
    x = _rhs(h.matrices[-1].nrows, 2)
    _close(got.inv, ref.inv)
    _close(got.mm(torch.from_numpy(x)), ref.mm(jnp.asarray(x)))


def _kstep_pair(ref_h, h, cls, jax_cls, iters):
    a_ref, a = ref_h.matrices[0], h.matrices[0]
    op_ref = jax_aslinearoperator(a_ref)
    return (
        cls(a=SparseOperator.from_csr(a, "cpu"),
            m=smoothers.build_smoother("l1", a, "cpu"), iters=iters),
        jax_cls(a=op_ref, m=jax_smoothers.build_smoother("l1", op_ref),
                iters=iters),
    )


# name -> (port operator, reference operator), built from level 0 (and
# the coarsest level for the dense ones) of the same hierarchy
OPERATORS = {
    "sparse_with_transpose": lambda r, h: (
        SparseOperator.from_csr(h.interpolations[0], "cpu",
                                with_transpose=True),
        jax_linop.SparseOperator.from_csr(r.interpolations[0],
                                          with_transpose=True),
    ),
    "l2_smoother": lambda r, h: (
        smoothers.build_smoother("l2", h.matrices[0], "cpu"),
        jax_smoothers.build_smoother(
            "l2", jax_aslinearoperator(r.matrices[0])),
    ),
    "jacobi_smoother": lambda r, h: (
        smoothers.build_smoother("jacobi", h.matrices[0], "cpu", omega=0.66),
        jax_smoothers.build_smoother(
            "jacobi", jax_aslinearoperator(r.matrices[0]), omega=0.66),
    ),
    "k_step": lambda r, h: _kstep_pair(
        r, h, smoothers.KStepSmoother, jax_smoothers.KStepSmoother, 3),
    "error_propagator": lambda r, h: _kstep_pair(
        r, h, smoothers.ErrorPropagator, jax_smoothers.ErrorPropagator, 2),
    "dense_pinv": lambda r, h: (
        DensePinvSolver.build(h.matrices[-1], "cpu"),
        JaxPinv.build(r.matrices[-1]),
    ),
    "dense": lambda r, h: (
        linop.aslinearoperator(h.matrices[-1].to_dense(), "cpu"),
        jax_aslinearoperator(r.matrices[-1].to_dense()),
    ),
    "scaled_identity": lambda r, h: (
        linop.ScaledIdentity(0.5, h.matrices[0].nrows),
        jax_linop.ScaledIdentity(jnp.asarray(0.5), r.matrices[0].nrows),
    ),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator(hierarchies, name):
    ref_h, h = hierarchies
    got, ref = OPERATORS[name](ref_h, h)
    assert tuple(got.shape) == tuple(ref.shape)
    n, m = got.shape
    for apply, size in (("mv", m), ("rmv", n)):
        for k in (None, 3):
            x = _rhs(size, k)
            method = apply if k is None else apply.replace("v", "m")
            _close(getattr(got, method)(torch.from_numpy(x)),
                   getattr(ref, method)(jnp.asarray(x)))


@pytest.mark.parametrize("cholqr", [False, True])
def test_orthonormalize(cholqr):
    x = _rhs(500, 6)
    if cholqr:
        ref, got = jax_qr.cholesky_qr(jnp.asarray(x)), qr.cholesky_qr(
            torch.from_numpy(x))
    else:
        ref, got = jax_qr.orthonormalize(jnp.asarray(x)), qr.orthonormalize(
            torch.from_numpy(x))
    assert got.is_contiguous()
    _close(got, ref)


@pytest.fixture(scope="module", params=["chebyshev", "block"])
def multigrids(hierarchies, request):
    ref_h, h = hierarchies
    kw = dict(smoother=request.param, dense_threshold=DENSE)
    jax_cfg = JaxMultigridConfig(**kw)
    ref = jax_cfg.build(ref_h)
    got = MultigridConfig(device="cpu", **kw).build(
        h, lambda_starts=reference_lambda_starts(jax_cfg, ref_h))
    assert any(isinstance(lvl.a, SparseOperator) for lvl in got.levels)
    # the 5-point level 0 is DIA (K3) in both packages
    assert isinstance(got.levels[0].a.mat, DIA)
    assert isinstance(ref.levels[0].a.ell, JaxDIA)
    return ref, got


@pytest.mark.parametrize("k", [None, 3])
def test_multigrid_cycle(multigrids, hierarchies, k):
    ref, got = multigrids
    x = _rhs(hierarchies[1].matrices[0].nrows, k)
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)))


def test_pcg_history(multigrids, hierarchies):
    ref_mg, mg = multigrids
    ref_h, h = hierarchies
    b = _rhs(h.matrices[0].nrows)
    _, ref_info = jax_cg(jax_aslinearoperator(ref_h.matrices[0]),
                         jnp.asarray(b), ref_mg, rtol=1e-10, maxiter=100)
    x, info = cg(SparseOperator.from_csr(h.matrices[0], "cpu"),
                 torch.from_numpy(b), mg, rtol=1e-10, maxiter=100)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    ref_hist = ref_info.history()
    np.testing.assert_allclose(info.history(), ref_hist, rtol=RTOL)
