"""K1 (csr_spmv_capped) + K2 (coo_patch) of tpu_amg_torch.ops.spmv.

On the CPU the wrappers run the kernels' plain PyTorch versions; these
tests hold them against scipy in float64 (1e-13 relative: the same sums
in another order) and against the reference's WELL Pallas kernel in
interpret mode in float32 (1e-5 relative: the reference computes in f32,
tpu_amg/ops/well_pallas.py:425-428).  The matrices are the WELL test
matrices (banded, wide band, heavy rows, rectangular, duplicate columns,
clustered heavy rows).  The CUDA cases run the kernels themselves and
skip without a card.

The module imports no JAX at the top, so that on a machine with a card
and no JAX the CUDA cases run with
``python -m pytest --noconftest tests/test_torch_spmv.py`` (the WELL
oracle case then skips).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from tpu_amg_torch.ops import spmv
from tpu_amg_torch.sparse.csr import CSR


def _random_banded(n, band, lo_deg, hi_deg, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        deg = rng.integers(lo_deg, hi_deg + 1)
        nbr = np.unique(np.clip(i + rng.integers(-band, band + 1, deg), 0, n - 1))
        rows += [i] * len(nbr)
        cols += list(nbr)
    vals = rng.standard_normal(len(rows))
    return sps.coo_matrix((vals, (rows, cols)), shape=(n, n))


def _rectangular():
    m = sps.random(500, 300, density=0.02, random_state=3).tocoo()
    keep = np.abs(m.col * (500 / 300) - m.row) < 50
    return sps.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])),
                          shape=m.shape)


def _duplicate_columns():
    # a 140-nnz row, past any row cap
    a = _random_banded(300, 20, 3, 6, seed=4).tolil()
    a[7, :140] = 1.0
    return a


def _clustered_heavy_rows():
    n = 4000
    rng = np.random.default_rng(7)
    a = _random_banded(n, 60, 3, 5, seed=7).tolil()
    for i in range(600, 630):
        cols = np.unique(rng.integers(i - 50, i + 50, 18).clip(0, n - 1))
        a[i, cols] = rng.standard_normal(len(cols))
    return a


# name -> (matrix generator, WELL.from_csr options of the reference test)
MATRICES = {
    "random_banded": (lambda: _random_banded(700, 50, 3, 11), {}),
    "wide_band": (lambda: _random_banded(2000, 400, 4, 9, seed=1), {}),
    "heavy_rows": (lambda: _random_banded(600, 60, 2, 30, seed=2), {}),
    "rectangular": (_rectangular, {}),
    "duplicate_columns": (_duplicate_columns, {"max_spill_frac": 0.5}),
    "clustered_heavy_rows": (_clustered_heavy_rows,
                             {"block": 4, "idroute": True}),
}


def _scipy(name):
    sp = MATRICES[name][0]().tocsr()
    sp.sum_duplicates()
    sp.sort_indices()
    return sp


def _x(ncols, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (ncols,) if k == 1 else (ncols, k)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("cap", [64, 8])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_matches_scipy_f64(name, k, cap):
    sp = _scipy(name)
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=cap)
    x = _x(sp.shape[1], k, np.float64)
    y = spmv.spmv(mat, torch.from_numpy(x)).numpy()
    ref = sp @ x
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_matches_well_interpret_f32(name):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_amg.ops.well_pallas import well_spmv
    from tpu_amg.sparse.csr import CSR as JaxCSR
    from tpu_amg.sparse.well import WELL

    sp = _scipy(name)
    well = WELL.from_csr(JaxCSR.from_scipy(sp), **MATRICES[name][1])
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float32)
    xs = _x(sp.shape[1], 3, np.float32, seed=1)
    ys = spmv.spmv(mat, torch.from_numpy(xs)).numpy()
    for j in range(xs.shape[1]):
        ref = np.asarray(well_spmv(well, jnp.asarray(xs[:, j]), interpret=True))
        np.testing.assert_allclose(ys[:, j], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        y = spmv.spmv(mat, torch.from_numpy(np.ascontiguousarray(xs[:, j])))
        np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_small_cap_split_is_exact():
    sp = _scipy("heavy_rows")
    csr = CSR.from_scipy(sp)
    (ip, ix, v), (tr, tc, tv) = spmv.split_capped(
        csr.indptr, csr.indices, csr.data, 4
    )
    assert len(tv) > 0
    assert np.diff(ip).max() == 4
    head = sps.csr_matrix((v, ix, ip), shape=sp.shape)
    tail = sps.coo_matrix((tv, (tr, tc)), shape=sp.shape)
    assert (head + tail - sp).count_nonzero() == 0
    mat = spmv.CappedCSR.from_csr(csr, "cpu", torch.float64, cap=4)
    assert mat.n_tail == len(tv) and mat.nnz == sp.nnz


@pytest.mark.parametrize("name", list(MATRICES))
def test_to_csr_round_trip(name):
    sp = _scipy(name)
    back = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                   cap=4).to_csr()
    assert back.shape == sp.shape
    np.testing.assert_array_equal(back.indptr, sp.indptr)
    np.testing.assert_array_equal(back.indices, sp.indices)
    np.testing.assert_array_equal(back.data, sp.data)


def test_k1_and_k2_alone():
    sp = _scipy("duplicate_columns")
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=16)
    x = torch.from_numpy(_x(sp.shape[1], 1, np.float64))
    y1 = spmv.csr_spmv_capped(mat, x)
    y2 = torch.zeros_like(y1)
    spmv.coo_patch(mat, x, y2)
    assert float(y2.abs().max()) > 0
    np.testing.assert_allclose((y1 + y2).numpy(), sp @ x.numpy(), rtol=0,
                               atol=1e-13 * np.abs(sp @ x.numpy()).max())


def test_wrapper_rejects_bad_input():
    sp = _scipy("rectangular")
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64)
    with pytest.raises(TypeError):
        spmv.spmv(mat, torch.zeros(sp.shape[1], dtype=torch.float32))
    with pytest.raises(ValueError):
        spmv.spmv(mat, torch.zeros(sp.shape[0], dtype=torch.float64))
    with pytest.raises(ValueError):
        spmv.spmv(mat, torch.zeros(sp.shape[1], 65, dtype=torch.float64))
    with pytest.raises(ValueError):
        spmv.spmv(mat, torch.zeros(3, sp.shape[1], dtype=torch.float64).T)
    with pytest.raises(ValueError):
        spmv.coo_patch(mat, torch.zeros(sp.shape[1], dtype=torch.float64),
                       torch.zeros(sp.shape[0], dtype=torch.float32))


def test_plain_versions_do_not_count_launches():
    sp = _scipy("heavy_rows")
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=8)
    before = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    spmv.spmv(mat, torch.ones(sp.shape[1], dtype=torch.float64))
    assert (spmv.csr_spmv_launches, spmv.coo_patch_launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("name", list(MATRICES))
def test_kernels_match_plain_on_card(cuda, name, k, dtype, tol):
    sp = _scipy(name)
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), cuda, dtype, cap=16)
    x = torch.from_numpy(_x(sp.shape[1], k, np.float64)).to(cuda, dtype)
    launches = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    y = spmv.spmv(mat, x)
    ref = spmv.plain_spmv(mat, x)
    torch.cuda.synchronize()
    assert spmv.csr_spmv_launches == launches[0] + 1
    assert spmv.coo_patch_launches == launches[1] + (mat.n_tail > 0)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= tol * scale
