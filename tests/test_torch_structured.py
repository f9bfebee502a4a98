"""Structured multigrid of the port (tpu_amg_torch.structured) against
the JAX package (tpu_amg.structured) on the same inputs.

Mirrors tests/test_structured.py case for case, and holds each port
object against the JAX one.  The multigrid parity cases build both
hierarchies in float64 on poisson3d(24) and on a 66x64x64 grid whose
level 2 is a capped CSR in the port, with the Chebyshev power
iterations started from the JAX package's own draws,
``jax.random.normal(PRNGKey(7), (n_l,))``, handed to the port as numpy.
On the CPU the port's DIA levels run K3's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_amg.interpolation.sa import smooth_interpolation as jax_smooth_interpolation
from tpu_amg.linop import DenseOperator as JaxDenseOperator
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.structured import SmoothedTransferP as JaxSmoothedTransferP
from tpu_amg.structured import StructuredInterp as JaxStructuredInterp
from tpu_amg.structured import build_structured_multigrid as jax_build
from tpu_amg.structured import structured_partition as jax_partition
from tpu_amg.utils import problems as jax_problems
from tpu_amg_torch.interpolation.sa import smooth_interpolation
from tpu_amg_torch.linop import DenseOperator, SparseOperator, aslinearoperator
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.structured import (
    SmoothedTransferP,
    StructuredInterp,
    TransposeOp,
    build_structured_multigrid,
    structured_partition,
)
from tpu_amg_torch.utils.problems import poisson2d, poisson3d

RTOL = 1e-10


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _weights(part):
    sizes = part.agg_sizes()
    return 1.0 / np.sqrt(sizes[part.node_to_agg].astype(np.float64))


def _interp_pair(shape):
    part, cs = structured_partition(shape)
    w = _weights(part)
    return (
        StructuredInterp(weights=torch.from_numpy(w), fine_shape=shape,
                         coarse_shape=cs),
        JaxStructuredInterp(weights=jnp.asarray(w), fine_shape=shape,
                            coarse_shape=cs),
    )


class TestStructuredPartition:
    def test_even_grid(self):
        part, cs = structured_partition((4, 4))
        assert cs == (2, 2)
        assert part.num_aggs == 4
        assert (part.agg_sizes() == 4).all()

    def test_odd_grid(self):
        part, cs = structured_partition((5, 3))
        assert cs == (3, 2)
        part.validate()
        assert part.num_aggs == 6

    @pytest.mark.parametrize("shape", [(4, 4), (5, 3), (7, 6, 5)])
    def test_matches_jax(self, shape):
        part, cs = structured_partition(shape)
        ref, ref_cs = jax_partition(shape)
        assert cs == ref_cs
        np.testing.assert_array_equal(part.node_to_agg, ref.node_to_agg)


class TestStructuredInterp:
    @pytest.mark.parametrize("shape", [(8, 8), (7, 5), (6, 6, 6), (5, 4, 3)])
    def test_matches_materialized(self, shape):
        interp, ref = _interp_pair(shape)
        p_dense = interp.to_csr().to_dense()
        np.testing.assert_array_equal(p_dense, ref.to_csr().to_dense())
        rng = np.random.default_rng(0)
        xc = rng.normal(size=interp.shape[1])
        xf = rng.normal(size=interp.shape[0])
        xs = rng.normal(size=(interp.shape[1], 3))
        ys = rng.normal(size=(interp.shape[0], 3))
        for got, want, jax_want in (
            (interp.mv(torch.from_numpy(xc)), p_dense @ xc,
             ref.mv(jnp.asarray(xc))),
            (interp.rmv(torch.from_numpy(xf)), p_dense.T @ xf,
             ref.rmv(jnp.asarray(xf))),
            (interp.mm(torch.from_numpy(xs)), p_dense @ xs,
             ref.mm(jnp.asarray(xs))),
            (interp.rmm(torch.from_numpy(ys)), p_dense.T @ ys,
             ref.rmm(jnp.asarray(ys))),
        ):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
            _close(got, jax_want, 1e-14)

    def test_orthonormal_columns(self):
        interp, _ = _interp_pair((8, 8))
        p = interp.to_csr().to_dense()
        np.testing.assert_allclose(p.T @ p, np.eye(16), atol=1e-12)


class TestSmoothedTransfer:
    def test_matches_materialized_smoothed_p(self):
        shape = (8, 8)
        a = poisson2d(*shape)
        tent, jax_tent = _interp_pair(shape)
        d_inv = 0.66 / a.diagonal()
        a_op = aslinearoperator(a, "cpu")
        assert isinstance(a_op.mat, DIA)
        lazy = SmoothedTransferP(tentative=tent, a=a_op,
                                 d_inv=torch.from_numpy(d_inv))
        ref = JaxSmoothedTransferP(
            tentative=jax_tent,
            a=jax_aslinearoperator(jax_problems.poisson2d(*shape)),
            d_inv=jnp.asarray(d_inv))
        p_mat = smooth_interpolation(a, tent.to_csr(), 0.66).to_dense()
        np.testing.assert_allclose(
            p_mat, jax_smooth_interpolation(
                jax_problems.poisson2d(*shape), jax_tent.to_csr(), 0.66
            ).to_dense(), rtol=0, atol=1e-15)
        rng = np.random.default_rng(1)
        xc = rng.normal(size=16)
        xf = rng.normal(size=64)
        got_mv = lazy.mv(torch.from_numpy(xc))
        got_rmv = TransposeOp(inner=lazy).mv(torch.from_numpy(xf))
        np.testing.assert_allclose(got_mv.numpy(), p_mat @ xc, atol=1e-10)
        np.testing.assert_allclose(got_rmv.numpy(), p_mat.T @ xf, atol=1e-10)
        _close(got_mv, ref.mv(jnp.asarray(xc)), 1e-14)
        _close(got_rmv, ref.rmv(jnp.asarray(xf)), 1e-14)
        xs = rng.normal(size=(16, 2))
        _close(lazy.mm(torch.from_numpy(xs)), p_mat @ xs, 1e-12)


def _jax_lambda_starts(mg):
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (lvl.a.shape[0],), jnp.float64))
            for lvl in mg.levels]


# grid -> (shape, coarsest_dim, the port's level formats).  At 24^3 the
# levels are DIA, dense, dense.  At 66x64x64 level 2 has 17*16*16 = 4352
# rows (over the 4096 of a dense level) and a Galerkin stencil outside
# the 160 / 8.0 DIA envelope: the port stores it as a capped CSR (K1 +
# K2, most rows spilling past cap 64), the JAX package as BandedDense.
GRIDS = {
    "24^3": ((24, 24, 24), 64, ("DIA", "dense", "dense")),
    "66x64x64": ((66, 64, 64), 1000, ("DIA", "DIA", "CSR")),
}


@pytest.fixture(scope="module", params=list(GRIDS))
def parity(request):
    """Both multigrids on one grid of GRIDS, float64."""
    shape, coarsest, formats = GRIDS[request.param]
    ref = jax_build(jax_problems.poisson3d(*shape), shape,
                    coarsest_dim=coarsest, dtype=jnp.float64)
    a = poisson3d(*shape)
    got = build_structured_multigrid(
        a, shape, device="cpu", coarsest_dim=coarsest, dtype=torch.float64,
        lambda_starts=_jax_lambda_starts(ref))
    return a, ref, got, formats, shape


def _format(op):
    if isinstance(op, DenseOperator):
        return "dense"
    return "DIA" if isinstance(op.mat, DIA) else "CSR"


def _level_matrix(op):
    """(offsets, values) of a DIA level, (None, matrix) of a dense one,
    ("csr", scipy matrix) of any other; for either package."""
    if isinstance(op, (DenseOperator, JaxDenseOperator)):
        return None, np.asarray(op.mat)
    mat = op.mat if isinstance(op, SparseOperator) else op.ell
    if hasattr(mat, "offsets"):
        return tuple(mat.offsets), np.asarray(mat.data)
    csr = mat.to_csr()
    return "csr", sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices),
         np.asarray(csr.indptr)), shape=csr.shape)


def test_multigrid_levels_match(parity):
    _, ref, got, formats, _ = parity
    assert len(got.levels) == len(ref.levels) == len(formats)
    assert tuple(_format(lvl.a) for lvl in got.levels) == formats
    assert len(got.levels[0].a.mat.offsets) == 7
    for lvl, (g, r) in enumerate(zip(got.levels, ref.levels)):
        g_off, g_val = _level_matrix(g.a)
        r_off, r_val = _level_matrix(r.a)
        assert g_off == r_off, lvl
        if g_off == "csr":
            assert g.a.mat.n_tail > 0  # K2 carries the rows past the cap
            g_val.eliminate_zeros()
            r_val.eliminate_zeros()
            assert g_val.nnz == r_val.nnz, lvl
            scale = abs(r_val).max()
            assert abs(g_val - r_val).max() <= 1e-12 * scale, lvl
        else:
            _close(g_val, r_val, 1e-12)
        assert g.smoother.lam_max == pytest.approx(float(r.smoother.lam_max),
                                                   rel=1e-12)
    _close(got.coarse_solver.inv, ref.coarse_solver.inv, 1e-12)


@pytest.mark.parametrize("k", [None, 3])
def test_vcycle_matches(parity, k):
    a, ref, got, _, _ = parity
    rng = np.random.default_rng(5)
    x = rng.standard_normal((a.nrows,) if k is None else (a.nrows, k))
    _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)), RTOL)


def test_pcg_matches(parity):
    a, ref, got, _, shape = parity
    x_true = np.random.default_rng(100).standard_normal(a.nrows)
    b = a.matvec(x_true)
    ref_a = jax_aslinearoperator(jax_problems.poisson3d(*shape))
    ref_x, ref_info = jax_cg(ref_a, jnp.asarray(b), ref, rtol=1e-6,
                             maxiter=100)
    x, info = cg(aslinearoperator(a, "cpu"), torch.from_numpy(b), got,
                 rtol=1e-6, maxiter=100)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters) <= 14
    _close(x, ref_x, 1e-8)
    np.testing.assert_allclose(info.history(), ref_info.history(), rtol=1e-8)


class TestStructuredMultigrid:
    @pytest.mark.parametrize("smoothing,limit", [(True, 12), (False, 30)])
    def test_poisson2d_convergence(self, smoothing, limit):
        a = poisson2d(32)
        mg = build_structured_multigrid(
            a, (32, 32), device="cpu", coarsest_dim=64, smoothing=smoothing,
            dtype=torch.float64)
        ref = jax_build(jax_problems.poisson2d(32), (32, 32), coarsest_dim=64,
                        smoothing=smoothing, dtype=jnp.float64)
        b = np.ones(a.nrows)
        _, info = cg(aslinearoperator(a, "cpu"), torch.from_numpy(b), mg,
                     rtol=1e-8)
        _, ref_info = jax_cg(jax_aslinearoperator(jax_problems.poisson2d(32)),
                             jnp.asarray(b), ref, rtol=1e-8)
        assert info.converged
        assert info.iters <= limit
        assert abs(info.iters - int(ref_info.iters)) <= 1

    def test_poisson3d_convergence(self):
        a = poisson3d(12)
        mg = build_structured_multigrid(
            a, (12, 12, 12), device="cpu", coarsest_dim=64,
            dtype=torch.float64)
        _, info = cg(aslinearoperator(a, "cpu"),
                     torch.ones(a.nrows, dtype=torch.float64), mg, rtol=1e-8)
        assert info.converged
        assert info.iters <= 15

    def test_float32_levels(self):
        a = poisson2d(32)
        mg = build_structured_multigrid(a, (32, 32), device="cpu",
                                        coarsest_dim=64)
        assert mg.levels[0].a.mat.dtype == torch.float32
        z = mg.mv(torch.ones(a.nrows, dtype=torch.float32))
        assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
