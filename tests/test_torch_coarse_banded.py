"""The banded Cholesky coarse solve (``BandedCholeskySolver``) against
the JAX package's: the host build (RCM permutation, the block-bidiagonal
slices and the diagonal blocks' inverses), the two-sweep apply against
the JAX apply (its ``lax.scan`` on the CPU) and a direct sparse solve,
the dispatch of ``build_coarse_solver``, the three budgets, the float32
cast, and a two-level classical cycle whose coarse solve is banded.
On the card (tests marked ``cuda``): the apply against the CPU's, and
under CUDA-graph capture.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

try:  # the reference: absent where only the card's tests run
    import jax
    import jax.numpy as jnp

    from tests.test_coarse_banded import _poisson2d_scrambled
    from tpu_amg.precision import cast_operator as jax_cast_operator
    from tpu_amg.preconditioners import coarse as jax_coarse
    from tpu_amg.sparse.csr import CSR as JaxCSR
except ImportError:
    jax = None

from tpu_amg_torch.errors import MultigridBuildError
from tpu_amg_torch.precision import cast_operator
from tpu_amg_torch.preconditioners import coarse
from tpu_amg_torch.preconditioners.coarse import (
    BandedCholeskySolver,
    build_coarse_solver,
)
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.utils import reorder

TOL = 1e-12


def _need_jax():
    if jax is None:
        pytest.skip("the JAX package (the reference) is not installed")


def _scrambled(nx, seed):
    """2-D Poisson with a random node relabelling (RCM has real work):
    the JAX test's generator, restated for the card's runs."""
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    eye = sps.identity(nx)
    a = (sps.kron(d, eye) + sps.kron(eye, d)).tocsr()
    p = np.random.default_rng(seed).permutation(nx * nx)
    a = a[p][:, p].tocsr()
    a.sort_indices()
    return a


def _rhs(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


def _direct(a, x):
    lu = spla.splu(a.tocsc())
    return lu.solve(x)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """(scipy matrix, JAX solver, port solver) on a scrambled 2-D
    Poisson matrix of 40² dofs: bandwidth past one 128-block, so the
    sweeps carry across blocks."""
    _need_jax()
    a = _poisson2d_scrambled(40, seed=0)
    np.testing.assert_array_equal(a.toarray(), _scrambled(40, 0).toarray())
    ref = jax_coarse.BandedCholeskySolver.build(JaxCSR.from_scipy(a),
                                                dtype=jnp.float64)
    got = BandedCholeskySolver.build(CSR.from_scipy(a), "cpu")
    return a, ref, got


def test_build_matches_jax(pair):
    a, ref, got = pair
    assert got.n == ref.n
    b = reorder.bandwidth(reorder.permute_symmetric(CSR.from_scipy(a),
                                                    got.perm.numpy()))
    nb, s_blk, _ = got.inv_l_diag.shape
    assert got.bandwidth == b and s_blk == max(128, -(-b // 128) * 128)
    assert got.inv_l_diag.shape == ref.inv_l_diag.shape
    assert nb >= 2 and s_blk == 128
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(got.iperm.numpy(), np.asarray(ref.iperm))
    for name in ("inv_l_diag", "sub"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    assert not got.sub[0].any()
    assert got.device_bytes() == 2 * got.inv_l_diag.numel() * 8


@pytest.mark.parametrize("k", [None, 4])
def test_apply_matches_jax_and_direct(pair, k):
    a, ref, got = pair
    x = _rhs(a.shape[0], k)
    y = got(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.mm(jnp.asarray(x)))
    assert y.shape == x.shape
    assert _rel(y, want) <= TOL
    assert _rel(y, _direct(a, x)) <= 1e-10
    assert torch.equal(got.mv(torch.from_numpy(x)), got(torch.from_numpy(x)))


def test_f32_cast_matches_jax(pair):
    """The cast keeps perm / iperm and casts the blocks; the apply widens
    them for float64 vectors, as the JAX cast's apply promotes."""
    _, ref, got = pair
    cast = cast_operator(got, torch.float32)
    ref_cast = jax_cast_operator(ref, jnp.float32)
    assert cast.inv_l_diag.dtype == cast.sub.dtype == torch.float32
    assert cast.perm.dtype == torch.int64 and torch.equal(cast.perm, got.perm)
    x = _rhs(got.n, 3, seed=2)
    y = cast(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_cast.mm(jnp.asarray(x)))
    assert y.dtype == np.float64
    assert _rel(y, want) <= TOL


def test_dispatch_above_dense_cap(monkeypatch):
    a = _scrambled(32, seed=4)  # 1,024 > 500
    monkeypatch.setattr(coarse, "DENSE_COARSE_CAP", 500)
    solver = build_coarse_solver("cholesky", CSR.from_scipy(a), "cpu")
    assert isinstance(solver, BandedCholeskySolver)
    x = _rhs(a.shape[0], None, seed=5)
    assert _rel(solver(torch.from_numpy(x)).numpy(), _direct(a, x)) <= 1e-10
    with pytest.raises(MultigridBuildError, match="too large for a dense"):
        build_coarse_solver("eigh", CSR.from_scipy(a), "cpu")
    monkeypatch.setattr(coarse, "DENSE_COARSE_CAP", 5000)
    assert isinstance(build_coarse_solver("cholesky", CSR.from_scipy(a), "cpu"),
                      coarse.DenseCholeskySolver)


@pytest.mark.parametrize("kind", ["banded", "banded_cholesky"])
def test_explicit_kind(kind):
    a = _scrambled(16, seed=6)
    solver = build_coarse_solver(kind, CSR.from_scipy(a), "cpu")
    assert isinstance(solver, BandedCholeskySolver)
    x = _rhs(a.shape[0], 2, seed=7)
    assert _rel(solver(torch.from_numpy(x)).numpy(), _direct(a, x)) <= 1e-10
    # a dense operand is accepted too
    dense = BandedCholeskySolver.build(a.toarray(), "cpu")
    assert torch.equal(dense.inv_l_diag, solver.inv_l_diag)


@pytest.mark.parametrize("budget,match", [
    (dict(max_bandwidth=64), "bandwidth"),
    (dict(max_factor_flops=1e5), "factorization cost"),
    (dict(max_device_bytes=1 << 16), "bytes on device"),
])
def test_budgets_raise(budget, match):
    """Each budget raises MultigridBuildError, with the JAX package's
    message, on a matrix whose RCM bandwidth passes 64."""
    rng = np.random.default_rng(7)
    n, m = 3000, 6000
    i, j = rng.integers(0, n, m), rng.integers(0, n, m)
    a = sps.coo_matrix((np.ones(m), (i, j)), shape=(n, n))
    a = (a + a.T + 50 * sps.identity(n)).tocsr()
    with pytest.raises(MultigridBuildError, match=match):
        BandedCholeskySolver.build(CSR.from_scipy(a), "cpu", **budget)
    if jax is not None:
        with pytest.raises(Exception, match=match):
            jax_coarse.BandedCholeskySolver.build(
                JaxCSR.from_scipy(a), dtype=jnp.float64, **budget)


def test_not_spd_raises():
    a = _scrambled(12, seed=8)
    with pytest.raises(MultigridBuildError, match="not SPD"):
        BandedCholeskySolver.build(CSR.from_scipy(-a), "cpu")


def test_two_level_cycle_with_banded_coarse(monkeypatch):
    """A two-level classical hierarchy whose coarse level passes the
    (lowered) dense cap: the builder's "cholesky" goes banded, and the
    cycle equals the one with the dense coarse solve."""
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg_torch.solver import AMGSolver, SolverConfig
    from tpu_amg_torch.utils.problems import poisson2d

    a = poisson2d(24)
    cfg = SolverConfig(device="cpu", method="classical", max_levels=2,
                       coarsening_near_null_dim=4, smoothing_iters=5,
                       coarsest_dim=50, dense_threshold=64)
    solver = AMGSolver.setup(a, cfg)
    h = solver.hierarchy
    assert h.num_levels == 2 and h.matrices[1].nrows > 100
    dense = solver.preconditioner
    assert isinstance(dense.coarse_solver, coarse.DenseCholeskySolver)
    monkeypatch.setattr(coarse, "DENSE_COARSE_CAP", 100)
    mg = MultigridConfig(smoother="chebyshev", smoothing_steps=2,
                         dense_threshold=64, device="cpu").build(h)
    assert isinstance(mg.coarse_solver, BandedCholeskySolver)
    assert mg.mu == 2
    r = torch.from_numpy(_rhs(a.nrows, None, seed=9))
    np.testing.assert_allclose(mg(r).numpy(), dense(r).numpy(), rtol=0,
                               atol=1e-10 * float(dense(r).abs().max()))


# ---- on the card

@pytest.fixture(scope="module")
def card_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = CSR.from_scipy(_scrambled(60, seed=10))
    return (BandedCholeskySolver.build(a, "cpu"),
            BandedCholeskySolver.build(a, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 8])
def test_banded_apply_on_card_matches_cpu(card_pair, k):
    cpu, card = card_pair
    x = torch.from_numpy(_rhs(cpu.n, k, seed=11))
    want = cpu(x)
    got = card(x.cuda()).cpu()
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.cuda
def test_banded_apply_in_a_cuda_graph(card_pair):
    _, card = card_pair
    x = torch.from_numpy(_rhs(card.n, None, seed=12)).cuda()
    want = card(x)
    static = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        card(static)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = card(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
