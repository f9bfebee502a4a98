"""The rest of the sparse package against the JAX package on the CPU.

``eye_csr``, ``diags_csr`` and ``sp_transpose`` exactly; ``ELL`` and
``BSR`` built from the same CSR in both packages (the same fields),
their applies at k = 1 and 8 and their reductions to 1e-12 relative in
float64, ``to_csr`` exactly, ``from_arrays`` from the JAX arrays; the
smoothers' diagonals, the dense coarse solve and the precision casts
over the containers; ``TransposeOperator``; PCG with A as an ELL (SA)
and as a BSR (block-3 elasticity) taking the JAX package's iterations;
and ``SparseOperator.from_csr``'s default formats on the SA, structured
and elasticity hierarchies, which this slice leaves as they were.

Inputs come from numpy seeds at small sizes.  On the CPU the containers
apply through K1's and K2's plain versions; the summation order differs
from the JAX package's gather-and-sum (ELL) and einsum (BSR), hence the
tolerance.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cycle import reference_lambda_starts
from tests.test_torch_elasticity import e2e_pair  # noqa: F401 (fixture)
from tpu_amg import linop as jax_linop
from tpu_amg import precision as jax_precision
from tpu_amg import sparse as jax_sparse
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners import coarse as jax_coarse
from tpu_amg.preconditioners import smoothers as jax_smoothers
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.utils import problems as jax_problems
from tpu_amg.utils.checkpoint import _pack_hierarchy
from tpu_amg_torch import sparse
from tpu_amg_torch.linop import SparseOperator, TransposeOperator
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.precision import cast_preconditioner
from tpu_amg_torch.preconditioners import coarse, smoothers
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse import BSR, CSR, DIA, ELL
from tpu_amg_torch.structured import build_structured_multigrid
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays

RTOL = 1e-12
KS = (1, 8)


def port_csr(m) -> CSR:
    """The port's CSR of a JAX package CSR (the same arrays)."""
    return CSR(data=np.asarray(m.data), indices=np.asarray(m.indices),
               indptr=np.asarray(m.indptr), shape=tuple(m.shape),
               block_size=m.block_size)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _matrices() -> dict:
    """JAX package CSRs: a Poisson matrix with stored zeros, a rectangular
    transfer with a hub row, and block-3 elasticity."""
    rng = np.random.default_rng(0)
    p = jax_problems.poisson2d(8)
    data = np.asarray(p.data).copy()
    off_diag = np.flatnonzero(np.asarray(p.indices) != np.repeat(
        np.arange(p.nrows), np.diff(np.asarray(p.indptr))))
    data[rng.choice(off_diag, 12, replace=False)] = 0.0  # stored zeros
    zeros = jax_sparse.CSR(data=data, indices=np.asarray(p.indices),
                           indptr=np.asarray(p.indptr), shape=p.shape)
    rows = np.concatenate([np.repeat(np.arange(30), 3),
                           np.zeros(40, dtype=np.int64)])  # row 0: a hub
    cols = np.concatenate([rng.integers(0, 90, 90), np.arange(40) * 2])
    rect = jax_sparse.from_coo(rows, cols, rng.standard_normal(rows.size),
                               (30, 90))
    return {"poisson_zeros": zeros, "rect": rect,
            "elasticity": jax_problems.unstructured_elasticity_3d(4)}


MATS = _matrices()


def _x(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k == 1 else (n, k))


# ---- host CSR functions


def test_eye_diags_transpose_match_jax():
    diag = np.random.default_rng(2).standard_normal(17)
    for got, want in ((sparse.eye_csr(9, 2.5), jax_sparse.eye_csr(9, 2.5)),
                      (sparse.diags_csr(diag), jax_sparse.diags_csr(diag)),
                      (sparse.sp_transpose(port_csr(MATS["rect"])),
                       jax_sparse.sp_transpose(MATS["rect"]))):
        assert got.shape == want.shape
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))


def test_sparse_all_holds_the_jax_names():
    assert set(jax_sparse.__all__) <= set(sparse.__all__)


# ---- ELL


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_fields_match_jax(name):
    m = MATS[name]
    ref = jax_sparse.ELL.from_csr(m)
    got = ELL.from_csr(port_csr(m), "cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert got.cols.dtype == torch.int32
    assert (got.shape, got.nnz, got.block_size, got.k) == (
        ref.shape, ref.nnz, ref.block_size, ref.k)
    # K1 + K2 apply the CSR's own entries: the CSR operator's capped CSR
    want = CappedCSR.from_csr(port_csr(m), "cpu")
    for f in ("indptr", "indices", "data", "tail_vals", "block_rows"):
        assert torch.equal(getattr(got.capped, f), getattr(want, f))
    assert ELL.from_csr(port_csr(m), "cpu", pad_to=8).k == ref.k + -ref.k % 8


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_apply_matches_jax(name, k):
    m = MATS[name]
    ref = jax_sparse.ELL.from_csr(m)
    got = ELL.from_csr(port_csr(m), "cpu")
    x = _x(m.shape[1], k)
    want = np.asarray(ref(jnp.asarray(x)))
    _close(got(torch.from_numpy(x)), want)
    _close((got.mv if k == 1 else got.mm)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_reductions_and_to_csr_match_jax(name):
    m = MATS[name]
    ref = jax_sparse.ELL.from_csr(m)
    got = ELL.from_csr(port_csr(m), "cpu")
    _close(got.row_sums(), ref.row_sums())
    _close(got.abs_row_sums(), ref.abs_row_sums())
    if m.shape[0] == m.shape[1]:
        _close(got.diagonal(), ref.diagonal())
    mine, theirs = got.to_csr(), ref.to_csr()
    assert mine.shape == theirs.shape
    assert mine.block_size == theirs.block_size
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(mine, f),
                                      np.asarray(getattr(theirs, f)))
    assert repr(got).startswith(f"ELL(shape={m.shape}, nnz={m.nnz}")


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_from_jax_arrays(name):
    """The JAX package's ELL carried across: the same arrays, its
    non-zero slots applied."""
    m = MATS[name]
    ref = jax_sparse.ELL.from_csr(m)
    got = ELL.from_arrays(np.asarray(ref.data), np.asarray(ref.cols),
                          ref.shape, ref.nnz, ref.block_size, "cpu")
    assert torch.equal(got.data, ELL.from_csr(port_csr(m), "cpu").data)
    assert got.capped.nnz == int(np.count_nonzero(np.asarray(ref.data)))
    for k in KS:
        x = _x(m.shape[1], k, seed=3)
        _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)))


# ---- BSR


def _bsr_case(bs):
    return MATS["elasticity"], bs


@pytest.mark.parametrize("bs", [3, 6])
def test_bsr_fields_match_jax(bs):
    m, _ = _bsr_case(bs)
    ref = jax_sparse.BSR.from_csr(m, block_size=bs)
    got = BSR.from_csr(port_csr(m), "cpu", block_size=bs)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert (got.shape, got.nnz, got.block_size, got.k, got.nrows,
            got.ncols) == (ref.shape, ref.nnz, ref.block_size, ref.k,
                           ref.nrows, ref.ncols)
    assert got.dtype == torch.float64 and np.asarray(ref.data).dtype == \
        np.float64
    # the CSR's stored entries in its order (bs 6 blocks pair two nodes)
    want = CappedCSR.from_csr(port_csr(m), "cpu")
    assert torch.equal(got.capped.indptr, want.indptr)
    assert torch.equal(got.capped.indices, want.indices)
    assert torch.equal(got.capped.data, want.data)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("bs", [3, 6])
def test_bsr_apply_and_reductions_match_jax(bs, k):
    m, _ = _bsr_case(bs)
    ref = jax_sparse.BSR.from_csr(m, block_size=bs)
    got = BSR.from_csr(port_csr(m), "cpu", block_size=bs)
    x = _x(m.shape[1], k)
    want = np.asarray(ref(jnp.asarray(x)))
    _close(got(torch.from_numpy(x)), want)
    _close((got.mv if k == 1 else got.mm)(torch.from_numpy(x)), want)
    _close(got.diagonal(), ref.diagonal())
    _close(got.row_sums(), ref.row_sums())
    _close(got.abs_row_sums(), ref.abs_row_sums())


@pytest.mark.parametrize("bs", [3, 6])
def test_bsr_from_jax_arrays(bs):
    m, _ = _bsr_case(bs)
    ref = jax_sparse.BSR.from_csr(m, block_size=bs)
    got = BSR.from_arrays(np.asarray(ref.data), np.asarray(ref.cols),
                          ref.shape, ref.nnz, bs, "cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    for k in KS:
        x = _x(m.shape[1], k, seed=4)
        _close(got(torch.from_numpy(x)), ref(jnp.asarray(x)))


def test_bsr_not_divisible_raises():
    m = MATS["elasticity"]  # 192 rows
    with pytest.raises(ValueError, match="not divisible"):
        jax_sparse.BSR.from_csr(m, block_size=5)
    with pytest.raises(ValueError, match="not divisible"):
        BSR.from_csr(port_csr(m), "cpu", block_size=5)


# ---- the smoothers, the coarse solve, the casts, the transpose view


def _containers(name):
    m = MATS[name]
    cs = {"ELL": (ELL.from_csr(port_csr(m), "cpu"),
                  jax_sparse.ELL.from_csr(m))}
    if m.block_size > 1:
        cs["BSR"] = (BSR.from_csr(port_csr(m), "cpu"),
                     jax_sparse.BSR.from_csr(m))
    return cs


@pytest.mark.parametrize("name", ["poisson_zeros", "elasticity"])
def test_smoother_diagonals_over_containers_match_jax(name):
    """l1, l2 and Jacobi from an ELL, a BSR and a SparseOperator over
    either, against the JAX package's over its ELL (its l2 takes the ELL
    layout) and, for l1 and Jacobi, its BSR."""
    jax_ell = jax_sparse.ELL.from_csr(MATS[name])
    for kind, (mat, jax_mat) in _containers(name).items():
        for fn in ("l1_inverse_diag", "l2_inverse_diag",
                   "jacobi_inverse_diag"):
            want = getattr(jax_smoothers, fn)(
                jax_ell if fn == "l2_inverse_diag" else jax_mat)
            for a in (mat, SparseOperator(mat=mat)):
                got = getattr(smoothers, fn)(a)
                assert isinstance(got, torch.Tensor)
                _close(got, want)
        op = smoothers.build_smoother("l2", mat, "cpu")
        _close(op.diag, jax_smoothers.l2_inverse_diag(jax_ell))
    with pytest.raises(TypeError, match="CappedCSR"):
        smoothers.l1_inverse_diag(SparseOperator.from_csr(
            port_csr(MATS[name]), "cpu", prefer_dia=False))


@pytest.mark.parametrize("name", ["poisson_zeros", "elasticity"])
def test_dense_coarse_solve_over_containers_matches_jax(name):
    m = MATS[name]
    want = np.asarray(jax_coarse.DenseCholeskySolver.build(m).inv)
    for kind, (mat, jax_mat) in _containers(name).items():
        if kind == "ELL":
            _close(np.asarray(jax_coarse.DenseCholeskySolver.build(
                jax_mat).inv), want)
        for a in (mat, SparseOperator(mat=mat)):
            _close(coarse.DenseCholeskySolver.build(a, "cpu").inv, want,
                   rtol=1e-10)
            _close(coarse._densify(a), m.to_dense(), rtol=0)


@pytest.mark.parametrize("mode", ["f32", "bf16_values"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_cast_operator_over_containers(name, mode):
    """A cast ELL- (or BSR-) backed operator: its padded values and its
    capped CSR in the mode's dtype, the same bits as the cast CSR-backed
    operator's apply, and the JAX package's cast ELL's apply to 1e-12."""
    m = MATS[name]
    x = torch.from_numpy(_x(m.shape[1], 1, seed=5))
    csr_op = cast_preconditioner(SparseOperator.from_csr(
        port_csr(m), "cpu", prefer_dia=False), mode)
    want = np.asarray(jax_precision.cast_preconditioner(
        jax_linop.SparseOperator(ell=jax_sparse.ELL.from_csr(m)),
        mode).mv(jnp.asarray(x.numpy())))
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    for kind, (mat, _) in _containers(name).items():
        op = cast_preconditioner(SparseOperator(mat=mat), mode)
        assert op.mat.data.dtype == op.mat.capped.data.dtype == dtype
        assert op.mat.capped.tail_vals.dtype == dtype
        assert mat.dtype == torch.float64  # the original is kept
        y = op.mv(x)
        assert y.dtype == torch.float64
        assert torch.equal(y, csr_op.mv(x)), kind
        _close(y, want)


def test_transpose_operator_matches_jax():
    m = MATS["rect"]  # 30 x 90
    base = SparseOperator.from_csr(port_csr(m), "cpu", with_transpose=True)
    ref = jax_linop.TransposeOperator(
        jax_linop.SparseOperator.from_csr(m, with_transpose=True))
    t = TransposeOperator(base)
    assert t.shape == ref.shape == (90, 30) and t.block_size == 1
    for k in KS:
        y = _x(30, k, seed=6)
        x = _x(90, k, seed=7)
        _close(t(torch.from_numpy(y)), ref(jnp.asarray(y)))
        got = (t.rmv if k == 1 else t.rmm)(torch.from_numpy(x))
        _close(got, (ref.rmv if k == 1 else ref.rmm)(jnp.asarray(x)))
    # over an ELL with its transpose: the base's rmv is the ELL's mv
    ell = SparseOperator(mat=ELL.from_csr(port_csr(m), "cpu"),
                         mat_t=ELL.from_csr(port_csr(m).transpose(), "cpu"))
    y = torch.from_numpy(_x(30, 1, seed=8))
    assert torch.equal(TransposeOperator(ell).mv(y), base.rmv(y))


@pytest.mark.parametrize("fmt", [ELL, BSR])
def test_containers_take_no_plain_version_off_the_cpu(fmt):
    """The plain versions run only for tensors on the CPU: elsewhere the
    apply launches K1 + K2 or raises (here, on the meta device)."""
    mat = fmt.from_csr(port_csr(MATS["elasticity"]), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        mat.mv(torch.zeros(mat.ncols, dtype=torch.float64, device="meta"))


def test_aslinearoperator_wraps_containers():
    from tpu_amg_torch.linop import aslinearoperator

    ell = ELL.from_csr(port_csr(MATS["elasticity"]), "cpu")
    op = aslinearoperator(ell, "cpu")
    assert isinstance(op, SparseOperator) and op.mat is ell
    assert op.block_size == 3


# ---- PCG with A as an ELL (SA) and as a BSR (block-3 elasticity)


@pytest.fixture(scope="module")
def sa_pair():
    """An SA hierarchy of poisson2d(32) built by the JAX package, loaded
    by the port through its archive arrays."""
    a = jax_problems.poisson2d(32)
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
    return ref, hierarchy_from_arrays(arrays, json.loads(json.dumps(meta)))


def _pcg_pair(ref_h, h, jax_mat, mat, jcfg, pcfg):
    """PCG of A x = 1 to 1e-8 with A as the container, in both packages:
    the same iterations, x to 1e-10; returns the port's (x, info, mg)."""
    ref_mg = jcfg.build(ref_h)
    mg = pcfg.build(h, reference_lambda_starts(jcfg, ref_h))
    n = h.matrices[0].nrows
    x_ref, ref_info = jax_cg(jax_linop.SparseOperator(ell=jax_mat),
                             jnp.ones(n), ref_mg, rtol=1e-8)
    x, info = cg(SparseOperator(mat=mat, block_size=mat.block_size),
                 torch.ones(n, dtype=torch.float64), mg, rtol=1e-8)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    _close(x, x_ref, rtol=1e-10)
    return x, info, mg


def test_sa_pcg_with_ell_matches_jax(sa_pair):
    ref_h, h = sa_pair
    a = ref_h.matrices[0]
    x, info, mg = _pcg_pair(
        ref_h, h, jax_sparse.ELL.from_csr(a), ELL.from_csr(port_csr(a), "cpu"),
        JaxMultigridConfig(smoother="chebyshev", smoothing_steps=1,
                           dense_threshold=64),
        MultigridConfig(smoother="chebyshev", smoothing_steps=1,
                        dense_threshold=64, device="cpu"))
    # the CSR-backed operator's iterates, bit for bit
    x_csr, i_csr = cg(SparseOperator.from_csr(port_csr(a), "cpu",
                                              prefer_dia=False),
                      torch.ones(a.nrows, dtype=torch.float64), mg, rtol=1e-8)
    assert i_csr.iters == info.iters
    assert torch.equal(x, x_csr)


def test_elasticity_pcg_with_bsr_matches_jax(e2e_pair):  # noqa: F811
    a_ref, ref_h, a, h, _, _ = e2e_pair
    _pcg_pair(ref_h, h, jax_sparse.BSR.from_csr(a_ref),
              BSR.from_csr(a, "cpu"),
              JaxMultigridConfig(smoother="chebyshev", smoothing_steps=1),
              MultigridConfig(smoother="chebyshev", smoothing_steps=1,
                              device="cpu"))


# ---- SparseOperator.from_csr's default formats, as they were

# each level's A, P and R as the builders picked them before the
# containers existed (the coarsest level is the coarse solve): DIA, a
# CappedCSR, a dense level, the structured path's own transfers
DEFAULT_FORMATS = {
    "sa": [("DIA", "CappedCSR", "CappedCSR"),
           ("DIA", "CappedCSR", "CappedCSR")],
    "unstructured": [("CappedCSR", "CappedCSR", "CappedCSR"),
                     ("DenseOperator", "CappedCSR", "CappedCSR")],
    "structured": [("DIA", "SmoothedTransferP", "TransposeOp")]
    + [("DenseOperator", "SmoothedTransferP", "TransposeOp")] * 2,
    "elasticity": [("DIA", "CappedCSR", "CappedCSR"),
                   ("DIA", "CappedCSR", "CappedCSR")],
}


def _formats(mg):
    return [tuple(type(op.mat).__name__ if isinstance(op, SparseOperator)
                  else type(op).__name__ for op in (lv.a, lv.p, lv.r))
            for lv in mg.levels]


def test_from_csr_default_formats_unchanged(sa_pair, e2e_pair):  # noqa: F811
    from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
    from tpu_amg_torch.interpolation import (AggregationConfig,
                                             InterpolationConfig)
    from tpu_amg_torch.partition import PartitionerConfig
    from tpu_amg_torch.utils.problems import (poisson2d, poisson3d,
                                              unstructured_poisson_2d)

    u = unstructured_poisson_2d(24)
    rng = np.random.default_rng(0)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((u.nrows, 1)), rng.standard_normal((u.nrows, 3))], 1))
    uh = HierarchyConfig(
        coarsest_dim=40, device="cpu",
        interpolation_config=InterpolationConfig(
            kind="aggregation", aggregation=AggregationConfig(
                candidate_dimension=2, partitioner_config=PartitionerConfig(
                    coarsening_factor=8.0)))).build(u, nn,
                                                    create_weights(u, nn))
    cfg = MultigridConfig(smoother="l1", dense_threshold=64, device="cpu")
    built = {
        "sa": cfg.build(sa_pair[1]),
        "unstructured": cfg.build(uh),
        "structured": build_structured_multigrid(
            poisson3d(24), (24,) * 3, device="cpu", coarsest_dim=64),
        "elasticity": cfg.build(e2e_pair[3]),
    }
    assert {name: _formats(mg) for name, mg in built.items()} == \
        DEFAULT_FORMATS
    # with default arguments no level becomes an ELL or a BSR
    for h in (sa_pair[1], uh, e2e_pair[3]):
        for m in h.matrices + h.interpolations + h.restrictions:
            assert isinstance(SparseOperator.from_csr(m, "cpu").mat,
                              (DIA, CappedCSR))
    # prefer_dia: a stencil is DIA by default, a capped CSR without
    assert isinstance(SparseOperator.from_csr(poisson2d(8), "cpu").mat, DIA)
    assert isinstance(SparseOperator.from_csr(poisson2d(8), "cpu",
                                              prefer_dia=False).mat,
                      CappedCSR)
