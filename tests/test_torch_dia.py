"""K3 (dia_spmv) and the DIA format of the port (tpu_amg_torch.sparse.dia).

Mirrors tests/test_dia.py case for case.  On the CPU the wrapper runs
K3's plain version; these tests hold it against the host CSR oracle,
against the JAX package's ``DIA.mv``/``mm`` (carried across with
``dia_from_arrays``), and against the DIA Pallas kernel itself in
interpret mode (``dia_spmv_pallas(..., interpret=True)``).  Tolerances:
1e-12 relative in float64 (the same sums, up to fused multiply-adds),
1e-5 in float32.  The format choice of ``SparseOperator.from_csr`` is
held against the JAX package's ``_pick_format``.  The CUDA cases run
the kernel itself and skip without a card.

JAX is imported inside the tests that use it, so that on a machine with
a card and no JAX the CUDA cases run with
``python -m pytest --noconftest tests/test_torch_dia.py``.
"""

import numpy as np
import pytest
import torch

from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.ops import dia as dia_ops
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA, dia_from_arrays, try_from_csr
from tpu_amg_torch.utils.problems import (
    poisson1d,
    poisson2d,
    poisson3d,
    unstructured_poisson_3d,
)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def _close(got, ref, rtol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _jax_csr(csr: CSR):
    from tpu_amg.sparse.csr import CSR as JaxCSR

    return JaxCSR(data=csr.data, indices=csr.indices, indptr=csr.indptr,
                  shape=csr.shape, block_size=csr.block_size)


def _jax_dia(csr: CSR, dtype, max_diags=32):
    import jax.numpy as jnp

    from tpu_amg.sparse.dia import try_from_csr as jax_try_from_csr

    return jax_try_from_csr(_jax_csr(csr), dtype=jnp.dtype(NP[dtype]),
                            max_diags=max_diags)


def _across(jax_dia, dtype):
    """The JAX package's DIA as the port's, through numpy arrays."""
    return dia_from_arrays(np.asarray(jax_dia.data), jax_dia.offsets,
                           jax_dia.shape, jax_dia.nnz, "cpu", dtype)


def _x(n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k == 1 else (n, k)).astype(NP[dtype])


def _galerkin_level(side: int) -> CSR:
    """Level 1 of the structured multigrid on poisson3d(side): the
    smoothed-aggregation Galerkin product, 33 diagonals in 3-D."""
    from tpu_amg_torch.interpolation.sa import smooth_interpolation
    from tpu_amg_torch.sparse.ops import spgemm
    from tpu_amg_torch.structured import StructuredInterp, structured_partition

    a = poisson3d(side)
    part, cs = structured_partition((side,) * 3)
    sizes = part.agg_sizes()
    w = 1.0 / np.sqrt(sizes[part.node_to_agg].astype(np.float64))
    p = StructuredInterp(torch.from_numpy(w), (side,) * 3, cs).to_csr()
    p = smooth_interpolation(a, p, 0.66)
    return spgemm(p.transpose(), spgemm(a, p))


class TestDIA:
    @pytest.mark.parametrize("gen", [poisson1d, poisson2d, poisson3d])
    def test_spmv_matches_oracle(self, gen):
        a = gen(5)
        dia = try_from_csr(a, "cpu")
        assert dia is not None
        x = np.random.default_rng(0).normal(size=a.ncols)
        np.testing.assert_allclose(
            dia.mv(torch.from_numpy(x)).numpy(), a.matvec(x), rtol=1e-12
        )

    def test_spmm_matches(self):
        a = poisson2d(6)
        dia = try_from_csr(a, "cpu")
        xs = np.random.default_rng(1).normal(size=(36, 5))
        np.testing.assert_allclose(
            dia.mm(torch.from_numpy(xs)).numpy(), a.to_dense() @ xs,
            rtol=1e-12,
        )

    def test_diagonal_and_row_sums(self):
        a = poisson3d(3)
        dia = try_from_csr(a, "cpu")
        np.testing.assert_allclose(dia.diagonal().numpy(), a.diagonal())
        np.testing.assert_allclose(dia.abs_row_sums().numpy(),
                                   a.abs_row_sums())
        np.testing.assert_allclose(dia.row_sums().numpy(), a.row_sums())

    def test_too_many_diagonals_returns_none(self):
        rng = np.random.default_rng(2)
        n = 64
        rows = rng.integers(0, n, 400)
        cols = rng.integers(0, n, 400)
        a = CSR.from_coo(rows, cols, np.ones(400), (n, n))
        assert try_from_csr(a, "cpu", max_diags=8) is None
        assert try_from_csr(a, "cpu", max_diags=None) is not None

    def test_non_square_returns_none(self):
        a = CSR.from_dense(np.ones((3, 4)))
        assert try_from_csr(a, "cpu") is None
        with pytest.raises(ValueError):
            DIA.from_csr(a, "cpu")

    def test_wraparound_annihilated(self):
        # offsets ±1 on a small chain: out-of-range reads must not leak
        a = poisson1d(5)  # tridiag 4x4
        dia = try_from_csr(a, "cpu")
        x = np.array([1.0, 10.0, 100.0, 1000.0])
        np.testing.assert_allclose(dia.mv(torch.from_numpy(x)).numpy(),
                                   a.matvec(x))

    def test_astype_and_fields(self):
        a = poisson2d(4, 3)
        dia = try_from_csr(a, "cpu")
        assert dia.offsets == (-3, -1, 0, 1, 3)
        assert dia.offsets_dev.tolist() == list(dia.offsets)
        assert dia.data.shape == (5, 12) and dia.nnz == a.nnz
        f32 = dia.astype(torch.float32)
        assert f32.dtype == torch.float32 and f32.offsets == dia.offsets


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("gen", [poisson1d, poisson2d, poisson3d])
def test_matches_jax_dia(gen, k, dtype):
    import jax.numpy as jnp

    a = gen(9)
    ref = _jax_dia(a, dtype)
    got = _across(ref, dtype)
    own = try_from_csr(a, "cpu", dtype)
    assert own.offsets == got.offsets == tuple(ref.offsets)
    np.testing.assert_array_equal(own.data.numpy(), got.data.numpy())
    x = _x(a.nrows, k, dtype)
    want = ref.mv(jnp.asarray(x)) if k == 1 else ref.mm(jnp.asarray(x))
    _close(got(torch.from_numpy(x)), want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_matches_pallas_interpret(dtype):
    """poisson3d(32): n = 32,768, a multiple of the Pallas kernel's tile."""
    import jax.numpy as jnp

    from tpu_amg.ops.dia_pallas import TILE, dia_spmv_pallas

    a = poisson3d(32)
    assert a.nrows % TILE == 0
    ref = _jax_dia(a, dtype)
    got = _across(ref, dtype)
    x = _x(a.nrows, 1, dtype, seed=3)
    want = np.asarray(dia_spmv_pallas(ref, jnp.asarray(x), interpret=True))
    _close(got.mv(torch.from_numpy(x)), want, TOL[dtype])


def test_galerkin_level_matches_pallas_interpret():
    """A 33-diagonal Galerkin level (16³ rows), zero-padded to a multiple
    of the Pallas kernel's tile as bench.py pads it."""
    import dataclasses

    import jax.numpy as jnp

    from tpu_amg.ops.dia_pallas import TILE, dia_spmv_pallas

    level = _galerkin_level(32)
    ref = _jax_dia(level, torch.float64, max_diags=160)
    assert len(ref.offsets) == 33
    n = level.nrows
    n_pad = -(-n // TILE) * TILE
    assert n_pad != n
    padded = dataclasses.replace(
        ref, data=jnp.pad(ref.data, ((0, 0), (0, n_pad - n))),
        shape=(n_pad, n_pad))
    x = _x(n, 1, torch.float64, seed=4)
    want = np.asarray(dia_spmv_pallas(padded, jnp.pad(jnp.asarray(x),
                                                      (0, n_pad - n)),
                                      interpret=True))[:n]
    got = _across(ref, torch.float64)
    _close(got.mv(torch.from_numpy(x)), want, 1e-12)
    _close(got.mv(torch.from_numpy(x)), level.matvec(x), 1e-12)


FORMAT_CASES = ["poisson1d", "poisson2d", "poisson3d", "galerkin_33",
                "sparse_diagonals", "unstructured", "rectangular"]


def _format_case(name: str) -> CSR:
    """A host CSR for the format-choice comparison."""
    rng = np.random.default_rng(6)
    n = 200
    if name == "sparse_diagonals":  # 4 diagonals, two of them almost empty
        return CSR.from_coo(
            np.r_[np.arange(n), 0, 1, n - 1],
            np.r_[np.arange(n), n - 1, n - 2, 0],
            np.r_[np.full(n, 4.0), -1.0, -1.0, -1.0], (n, n))
    if name == "rectangular":
        return CSR.from_coo(rng.integers(0, 30, 90), rng.integers(0, 20, 90),
                            np.ones(90), (30, 20))
    return {
        "poisson1d": lambda: poisson1d(40),
        "poisson2d": lambda: poisson2d(12),
        "poisson3d": lambda: poisson3d(8),
        "galerkin_33": lambda: _galerkin_level(16),
        "unstructured": lambda: unstructured_poisson_3d(10),
    }[name]()


@pytest.mark.parametrize("envelope", [{}, dict(dia_max_diags=160,
                                                dia_max_density=8.0)])
@pytest.mark.parametrize("name", FORMAT_CASES)
def test_format_choice_matches_jax(name, envelope):
    from tpu_amg.linop import SparseOperator as JaxSparseOperator
    from tpu_amg.sparse.dia import DIA as JaxDIA

    csr = _format_case(name)
    got = SparseOperator.from_csr(csr, "cpu", **envelope)
    ref = JaxSparseOperator.from_csr(_jax_csr(csr), prefer_well=False,
                                     **envelope)
    assert isinstance(got.mat, DIA) == isinstance(ref.ell, JaxDIA)
    if name == "unstructured":
        assert isinstance(got.mat, CappedCSR)
    if name in ("poisson1d", "poisson2d", "poisson3d"):
        assert isinstance(got.mat, DIA)
    if name == "galerkin_33":
        assert isinstance(got.mat, DIA) == bool(envelope)
    x = _x(csr.ncols, 1, torch.float64)
    _close(got.mv(torch.from_numpy(x)), csr.matvec(x), 1e-12)


def test_dia_operator_transpose():
    a = poisson2d(7)
    op = SparseOperator.from_csr(a, "cpu", with_transpose=True)
    assert isinstance(op.mat, DIA) and isinstance(op.mat_t, DIA)
    plain = SparseOperator.from_csr(a, "cpu")
    assert plain.mat_t is None
    x = torch.from_numpy(_x(a.nrows, 3, torch.float64))
    _close(plain.rmm(x), a.to_dense().T @ x.numpy(), 1e-12)
    _close(op.rmv(x[:, 0].contiguous()), a.to_dense().T @ x[:, 0].numpy(),
           1e-12)


def test_wrapper_rejects_bad_input():
    dia = try_from_csr(poisson2d(5), "cpu")
    with pytest.raises(TypeError):
        dia.mv(torch.zeros(25, dtype=torch.float32))
    with pytest.raises(ValueError):
        dia.mv(torch.zeros(24, dtype=torch.float64))
    with pytest.raises(ValueError):
        dia.mm(torch.zeros(25, 65, dtype=torch.float64))
    with pytest.raises(ValueError):
        dia.mm(torch.zeros(3, 25, dtype=torch.float64).T)
    assert dia.mm(torch.zeros(25, 64, dtype=torch.float64)).shape == (25, 64)


def test_no_kernel_off_cpu_and_cuda():
    dia = try_from_csr(poisson2d(3), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        dia.mv(torch.zeros(9, dtype=torch.float64, device="meta"))


def test_plain_version_does_not_count_launches():
    dia = try_from_csr(poisson3d(4), "cpu")
    before = dia_ops.dia_spmv_launches
    dia.mv(torch.ones(64, dtype=torch.float64))
    assert dia_ops.dia_spmv_launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 7, 8, 64])
@pytest.mark.parametrize("name", ["poisson1d", "poisson3d", "galerkin_33"])
def test_kernel_matches_plain_on_card(cuda, name, k, dtype):
    csr = {"poisson1d": lambda: poisson1d(1000),
           "poisson3d": lambda: poisson3d(20),
           "galerkin_33": lambda: _galerkin_level(20)}[name]()
    dia = try_from_csr(csr, cuda, dtype, max_diags=None)
    x = torch.from_numpy(_x(csr.nrows, k, dtype)).to(cuda)
    before = dia_ops.dia_spmv_launches
    y = dia(x)
    ref = dia_ops.plain_dia_spmv(dia, x)
    torch.cuda.synchronize()
    assert dia_ops.dia_spmv_launches == before + 1
    assert float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())
