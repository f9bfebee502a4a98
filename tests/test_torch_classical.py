"""Classical AMG (compatible relaxation + least-squares interpolation)
against the JAX package: the strength graph's maximal independent set,
the block smoother's cached build and host apply, the batched LS
solvers, the C-point selection, the LS interpolation and its Galerkin
coarse operator, the facade's classical setup with its W-cycle, the
auto cycle index, and the two-level truncation.

The host steps are numpy in both packages: integer arrays are compared
bit for bit and floats to 1e-12 relative.  The cycle applies agree to
1e-10 and the PCG iteration counts are equal.  Small sizes: grids of
32² or fewer.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:  # the reference: absent where only the card's tests run
    import jax
    import jax.numpy as jnp

    from tests.test_torch_cycle import reference_lambda_starts
    from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
    from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
    from tpu_amg.interpolation import classical as jax_classical
    from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
    from tpu_amg.partition import strength_graph as jax_strength_graph
    from tpu_amg.preconditioners import block_smoother as jax_block_smoother
    from tpu_amg.solver import AMGSolver as JaxSolver
    from tpu_amg.solver import SolverConfig as JaxConfig
    from tpu_amg.utils import problems as jax_problems
except ImportError:
    jax = None

from tpu_amg_torch.hierarchy import HierarchyConfig
from tpu_amg_torch.interpolation import InterpolationConfig, classical
from tpu_amg_torch.partition import Partition, strength_graph
from tpu_amg_torch.preconditioners import block_smoother
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solver import AMGSolver, SolverConfig
from tpu_amg_torch.utils import checkpoint, problems

HOST_TOL = 1e-12  # host floats, relative to the largest entry
CYCLE_TOL = 1e-10  # cycle applies


def _need_jax():
    if jax is None:
        pytest.skip("the JAX package (the reference) is not installed")


def _close(got, want, tol=HOST_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _assert_csr_equal(got, want, tol=HOST_TOL):
    assert got.shape == want.shape and got.block_size == want.block_size
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    _close(got.data, want.data, tol)


def _problem(name, side):
    """(reference CSR, port CSR) of poisson2d or aniso2d at ``side``."""
    if name == "poisson":
        return jax_problems.poisson2d(side), problems.poisson2d(side)
    return (jax_problems.anisotropic_diffusion_2d(side),
            problems.anisotropic_diffusion_2d(side))


def _basis(n, k=4, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(np.concatenate(
        [np.ones((n, 1)), rng.standard_normal((n, k - 1))], 1))
    return q


# ---- the defaults: classical, in both packages

def test_defaults_match_jax():
    _need_jax()
    got, want = InterpolationConfig(), JaxInterpolationConfig()
    assert got.kind == want.kind == "classical"
    assert dataclasses.asdict(got.classical) == dataclasses.asdict(
        want.classical)
    assert got.coarse_block_size == want.coarse_block_size == 1
    sa = InterpolationConfig(kind="aggregation")
    assert sa.coarse_block_size == sa.aggregation.candidate_dimension
    assert (HierarchyConfig().interpolation_config.kind
            == JaxHierarchyConfig().interpolation_config.kind)
    for name in ("MIN_ABS", "MIN_REL", "FEAS_TOL", "RIDGE_ETA"):
        assert getattr(classical, name) == getattr(jax_classical, name)
    with pytest.raises(ValueError, match="unknown interpolation kind"):
        InterpolationConfig(kind="smoothed").build(None, None, None)


# ---- the strength graph's maximal independent set

@pytest.mark.parametrize("mask", ["all", "random"])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_mis_matches_jax(name, mask):
    _need_jax()
    ref_a, a = _problem(name, 16)
    nn = _basis(a.nrows)
    w = np.ones(4)
    ref_g, g = jax_strength_graph(ref_a, nn, w), strength_graph(a, nn, w)
    assert (g.adj != ref_g.adj).nnz == 0
    f = (np.ones(a.nrows, dtype=bool) if mask == "all"
         else np.random.default_rng(1).random(a.nrows) < 0.6)
    f_ref = f.copy()
    c = g.maximal_independent_set(f)
    c_ref = ref_g.maximal_independent_set(f_ref)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(f, f_ref)
    assert c.dtype == np.int64 and not f.any()
    # independent over the symmetrized pattern
    sym = g._sym()
    assert sym[c][:, c].nnz == 0 and g._sym() is sym


# ---- the block smoother: cached build, host apply, incremental rebuild

def _smoother_case():
    ref_a, a = _problem("poisson", 16)
    part = Partition(np.arange(a.nrows) // 24)
    return ref_a, a, part


@pytest.mark.parametrize("host_only", [True, False])
def test_block_smoother_cached_matches_jax(host_only):
    _need_jax()
    ref_a, a, part = _smoother_case()
    sm, cache = block_smoother.BlockSmoother.build_cached(
        a, part, "cpu", host_only=host_only)
    ref_sm, ref_cache = jax_block_smoother.BlockSmoother.build_cached(
        ref_a, part, host_only=host_only)
    assert (sm is None) == (ref_sm is None) == host_only
    kind = "chol" if host_only else "inv"
    assert cache["by_size"].keys() == ref_cache["by_size"].keys()
    for s_b, e in cache["by_size"].items():
        r = ref_cache["by_size"][s_b]
        np.testing.assert_array_equal(e["blocks"], r["blocks"])
        np.testing.assert_array_equal(e["idx"], r["idx"])
        np.testing.assert_array_equal(e["mask"], r["mask"])
        _close(e[kind], r[kind])
    x = np.random.default_rng(2).standard_normal(a.nrows)
    _close(block_smoother.host_apply(cache, x),
           jax_block_smoother.host_apply(ref_cache, x))
    if not host_only:
        # the device apply is the cache's inverses
        _close(sm(torch.from_numpy(x)).numpy(),
               block_smoother.host_apply(cache, x))
        again = block_smoother.BlockSmoother.build(a, part, "cpu")
        assert torch.equal(again(torch.from_numpy(x)),
                           sm(torch.from_numpy(x)))


def test_block_smoother_incremental_is_fresh():
    """Compatible relaxation's rebuild: C rows and columns zeroed (unit
    diagonal at C) re-factor only the changed aggregates, and give the
    fresh build's factors bit for bit."""
    _, a, part = _smoother_case()
    _, cache = block_smoother.BlockSmoother.build_cached(
        a, part, host_only=True)
    c = np.random.default_rng(3).random(a.nrows) < 0.1
    rows, cols, vals = a.coo()
    keep = (~c).astype(np.float64)
    data = vals * keep[rows] * keep[cols]
    data[np.flatnonzero((rows == cols) & c[rows])] = 1.0
    a_f = dataclasses.replace(a, data=data)
    _, inc = block_smoother.BlockSmoother.build_cached(
        a_f, part, cache=cache, host_only=True)
    _, fresh = block_smoother.BlockSmoother.build_cached(
        a_f, part, host_only=True)
    for s_b, e in fresh["by_size"].items():
        np.testing.assert_array_equal(inc["by_size"][s_b]["chol"], e["chol"])
    x = np.random.default_rng(4).standard_normal(a.nrows)
    np.testing.assert_array_equal(block_smoother.host_apply(inc, x),
                                  block_smoother.host_apply(fresh, x))
    # a singular block fails Cholesky and is lifted by 1e-10 of its trace
    blocks = np.array([[[1.0, 1.0], [1.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]])
    lift = blocks + 1e-10 * np.array([2.0, 5.0])[:, None, None] * np.eye(2)
    np.testing.assert_array_equal(block_smoother._spd_cholesky(blocks),
                                  np.linalg.cholesky(lift))


# ---- the batched least-squares solvers

def _grams(s, r, seed, singular=True):
    """s seeded SPD Grams of size r, the last quarter singular, and
    right-hand sides."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((s, r, r + 2))
    gram = np.einsum("sik,sjk->sij", v, v)
    if singular:
        q = s // 4
        gram[-q:, :, -1] = gram[-q:, :, 0]
        gram[-q:, -1, :] = gram[-q:, 0, :]
    return gram, rng.standard_normal((s, r))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_spd_solve_small_matches_jax(r):
    _need_jax()
    gram, rhs = _grams(64, r, seed=r)
    x, ok = classical._spd_solve_small(gram, rhs)
    x_ref, ok_ref = jax_classical._spd_solve_small(gram, rhs)
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_array_equal(np.isfinite(x), np.isfinite(x_ref))
    _close(x[ok], x_ref[ok])
    if r in (2, 3):  # closed forms: the singular quarter falls back
        assert not ok.all()
    elif r > 3:  # the pseudo-inverse certifies every row
        assert ok.all()
    _close(classical._solve_lin(gram, rhs), jax_classical._solve_lin(gram, rhs))


def test_batched_pinv_matches_jax():
    _need_jax()
    gram, rhs = _grams(40, 3, seed=5)
    _close(classical._batched_pinv_solve(gram, rhs),
           jax_classical._batched_pinv_solve(gram, rhs))


@pytest.mark.parametrize("mode", ["constrained", "regularized"])
def test_subset_solvers_match_jax(mode):
    _need_jax()
    gram, gf = _grams(48, 3, seed=6)
    gf = np.abs(gf)
    btb = np.random.default_rng(7).random(48) + 10.0
    fn = "_solve_subsets_" + mode
    p, err, valid = getattr(classical, fn)(gram, gf, btb)
    p_ref, err_ref, valid_ref = getattr(jax_classical, fn)(gram, gf, btb)
    np.testing.assert_array_equal(valid, valid_ref)
    _close(p, p_ref)
    _close(err, err_ref)


@pytest.mark.parametrize("mode,gamma", [("constrained", 1.2),
                                        ("regularized", None)])
def test_ls_interp_weights_matches_jax(mode, gamma):
    _need_jax()
    rng = np.random.default_rng(8)
    d = np.abs(rng.standard_normal(3)) + 0.1
    for _ in range(12):
        vf, vc = rng.standard_normal(3), rng.standard_normal((5, 3))
        w, s, e = classical.ls_interp_weights(vf, vc, d, 3, gamma, mode)
        w_ref, s_ref, e_ref = jax_classical.ls_interp_weights(
            vf, vc, d, 3, gamma, mode)
        assert s == s_ref
        _close(w, w_ref)
        _close(e, e_ref)


def test_batch_matches_jax_and_per_point():
    """The bucketed batch against the JAX batch (the same arrays), and
    against the per-point path on the achieved interpolation error."""
    _need_jax()
    rng = np.random.default_rng(9)
    P, L, k = 20, 5, 3
    vf = rng.standard_normal((P, k))
    vc = rng.standard_normal((P, L, k))
    d = np.abs(rng.standard_normal(k)) + 0.1
    got = classical._ls_interp_weights_batch(vf, vc, d, 3, 1.2, "constrained")
    want = jax_classical._ls_interp_weights_batch(vf, vc, d, 3, 1.2,
                                                  "constrained")
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    w_all, set_all, size_all = got
    for p in range(P):
        w, s, _ = classical.ls_interp_weights(vf[p], vc[p], d, 3, 1.2,
                                              "constrained")
        assert size_all[p] == len(s)

        def err(wp, sp):
            r = vf[p] - np.asarray(wp) @ vc[p][np.asarray(sp, dtype=int)]
            return float(r @ (d * r))

        n_p = size_all[p]
        assert abs(err(w_all[p, :n_p], set_all[p, :n_p]) - err(w, s)) < (
            1e-9 * (1 + abs(err(w, s))))


# ---- the C/F split and the LS interpolation

@pytest.mark.parametrize("side", [16, 32])
def test_compatible_relaxation_matches_jax(side):
    _need_jax()
    ref_a, a = _problem("poisson", side)
    nn = _basis(a.nrows)
    w = np.ones(4)
    part = Partition(np.arange(a.nrows) // 32)
    cr = classical.CompatibleRelaxationConfig()
    state = classical.compatible_relaxation(
        a, strength_graph(a, nn, w, 3), part, cr)
    ref = jax_classical.compatible_relaxation(
        ref_a, jax_strength_graph(ref_a, nn, w, 3), part,
        jax_classical.CompatibleRelaxationConfig())
    np.testing.assert_array_equal(state, ref)
    assert state.dtype == np.int8
    assert 0 < (state == classical._C).sum() < a.nrows


@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_least_squares_interpolation_matches_jax(name):
    _need_jax()
    ref_a, a = _problem(name, 16)
    nn = _basis(a.nrows)
    w = 1.0 / np.einsum("nk,nk->k", nn, a.matvec(nn))
    got = classical.ClassicalConfig().build(a, nn, w)
    want = jax_classical.ClassicalConfig().build(ref_a, nn, w)
    assert got.kind == want.kind == "classical"
    np.testing.assert_array_equal(got.partition.c_points,
                                  want.partition.c_points)
    np.testing.assert_array_equal(got.partition.node_to_agg,
                                  want.partition.node_to_agg)
    _assert_csr_equal(got.interpolation, want.interpolation)
    _assert_csr_equal(got.restriction, want.restriction)
    _assert_csr_equal(got.coarse_mat, want.coarse_mat)
    np.testing.assert_array_equal(got.coarse_nn, want.coarse_nn)
    c0 = int(got.partition.c_points[0])
    assert got.partition.coarse_idx(c0) == 0
    # an F-point has no coarse index
    f0 = int(np.flatnonzero(~np.isin(np.arange(a.nrows),
                                      got.partition.c_points))[0])
    assert got.partition.coarse_idx(f0) is None


# ---- the facade: classical setup, W-cycle and PCG in both packages

FACADE = dict(method="classical", coarsening_near_null_dim=8,
              smoothing_iters=10, coarsest_dim=60, dense_threshold=64)
FACADE_SIDE = 32


@pytest.fixture(scope="module")
def facade_pair():
    """(JAX solver, port solver from the JAX package's draws, b)."""
    _need_jax()
    cfg = JaxConfig(**FACADE)
    ref = JaxSolver.setup(jax_problems.poisson2d(FACADE_SIDE), cfg)
    n, k = FACADE_SIDE ** 2, cfg.coarsening_near_null_dim - 1
    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    starts = tuple(np.asarray(jax.random.normal(key, (n, k), jnp.float64))
                   for key in (k1, k2))
    lam = reference_lambda_starts(JaxSolver._mg_config(cfg), ref.hierarchy)
    got = AMGSolver.setup(problems.poisson2d(FACADE_SIDE),
                          SolverConfig(device="cpu", **FACADE),
                          near_null_starts=starts, lambda_starts=lam)
    b = problems.poisson2d(FACADE_SIDE).matvec(
        np.random.default_rng(5).standard_normal(n))
    return ref, got, b, starts, lam


def test_classical_setup_matches_jax(facade_pair):
    ref, got, _, _, _ = facade_pair
    h, want = got.hierarchy, ref.hierarchy
    assert h.num_levels == want.num_levels >= 3
    assert h.partition_kinds == want.partition_kinds
    assert set(h.partition_kinds) == {"classical"}
    for lists in ("matrices", "interpolations", "restrictions"):
        for m, w in zip(getattr(h, lists), getattr(want, lists)):
            _assert_csr_equal(m, w)
    for p, q in zip(h.partitions, want.partitions):
        np.testing.assert_array_equal(p.c_points, q.c_points)
    assert [m.block_size for m in h.matrices] == [1] * h.num_levels


def test_wcycle_matches_jax(facade_pair):
    ref, got, b, _, _ = facade_pair
    assert got.preconditioner.mu == ref.preconditioner.mu == 2
    for k in (None, 3):
        r = np.random.default_rng(6).standard_normal(
            (len(b),) if k is None else (len(b), k))
        want = np.asarray(ref.apply_preconditioner(jnp.asarray(r)))
        _close(got.apply_preconditioner(torch.from_numpy(r)).numpy(), want,
               CYCLE_TOL)


def test_classical_pcg_matches_jax(facade_pair):
    ref, got, b, _, _ = facade_pair
    _, ref_info = ref.solve(jnp.asarray(b), rtol=1e-8)
    x, info = got.solve(b, rtol=1e-8)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    np.testing.assert_allclose(info.history(), ref_info.history(), rtol=1e-8)
    res = np.linalg.norm(b - got.matrix.matvec(x.numpy())) / np.linalg.norm(b)
    assert res <= 1e-8


@pytest.mark.parametrize("method,mu,want", [
    ("classical", None, 2), ("sa", None, 1), ("classical", 1, 1),
    ("sa", 3, 3)])
def test_auto_cycle_index(facade_pair, method, mu, want):
    """μ: 2 for a classical hierarchy and 1 for SA when ``mu`` is None;
    an explicit ``mu`` is honoured (the JAX builder's rule)."""
    _, got, _, _, _ = facade_pair
    h = got.hierarchy
    if method == "sa":
        h = dataclasses.replace(h, partition_kinds=["aggregation"]
                                * len(h.partition_kinds))
    cfg = MultigridConfig(mu=mu, smoother="chebyshev", dense_threshold=64,
                          device="cpu")
    assert cfg.cycle_index(h) == want
    assert cfg.build(h).mu == want


def test_classical_checkpoint_keeps_w_cycle(facade_pair, tmp_path):
    _, got, b, _, lam = facade_pair
    path = tmp_path / "classical.npz"
    got.save(path)
    loaded = AMGSolver.load(path, got.matrix,
                            SolverConfig(device="cpu", **FACADE),
                            lambda_starts=lam)
    assert loaded.hierarchy.partition_kinds == got.hierarchy.partition_kinds
    assert loaded.preconditioner.mu == 2
    r = torch.from_numpy(b)
    assert torch.equal(loaded.apply_preconditioner(r),
                       got.apply_preconditioner(r))
    h = checkpoint.load_hierarchy(path)
    assert "classical" in h.partition_kinds


def test_two_level_truncation_is_a_max_levels_2_setup(facade_pair):
    """Levels 0-1 of the full hierarchy are the hierarchy a setup with
    max_levels = 2 builds from the same draws."""
    _, got, b, starts, _ = facade_pair
    two = AMGSolver.setup(problems.poisson2d(FACADE_SIDE),
                          SolverConfig(device="cpu", max_levels=2, **FACADE),
                          near_null_starts=starts).hierarchy
    cut = got.hierarchy.truncated(2)
    assert cut.num_levels == two.num_levels == 2
    assert cut.config.max_levels == two.config.max_levels == 2
    assert cut.partition_kinds == two.partition_kinds == ["classical"]
    for lists in ("matrices", "interpolations", "restrictions"):
        for m, w in zip(getattr(cut, lists), getattr(two, lists)):
            _assert_csr_equal(m, w, tol=0.0)
    for lists in ("near_nulls", "nn_weights"):
        for m, w in zip(getattr(cut, lists), getattr(two, lists)):
            np.testing.assert_array_equal(m, w)
    with pytest.raises(ValueError, match="num_levels"):
        got.hierarchy.truncated(0)


# ---- on the card: K1 + K2 at the classical path's shapes

@pytest.fixture(scope="module")
def card_classical():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = problems.poisson2d(64)
    return AMGSolver.setup(a, SolverConfig(device="cuda", **FACADE))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["A0", "A1", "P0", "R0", "P1", "R1"])
@pytest.mark.parametrize("k", [1, 8])
def test_k1_k2_at_classical_shapes(card_classical, which, k):
    from tpu_amg_torch.ops import spmv

    h = card_classical.hierarchy
    letter, lvl = which[0], int(which[1])
    host = {"A": h.matrices, "P": h.interpolations,
            "R": h.restrictions}[letter][lvl]
    mat = spmv.CappedCSR.from_csr(host, "cuda", torch.float64)
    g = torch.Generator(device="cuda").manual_seed(k)
    shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    y, again = spmv.spmv(mat, x), spmv.spmv(mat, x)
    p = spmv.plain_spmv(mat, x)
    assert float((y - p).abs().max()) <= 1e-12 * float(p.abs().max())
    assert torch.equal(y, again)
