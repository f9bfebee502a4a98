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
    before = (spmv.csr_spmv_launches, spmv.coo_patch_launches,
              dict(spmv.csr_spmv_launches_by_shape))
    spmv.spmv(mat, torch.ones(sp.shape[1], dtype=torch.float64))
    spmv.spmv(mat, torch.ones(sp.shape[1], 3, dtype=torch.float64))
    spmv.plain_spmv(mat, torch.ones(sp.shape[1], dtype=torch.float64))
    assert (spmv.csr_spmv_launches, spmv.coo_patch_launches,
            dict(spmv.csr_spmv_launches_by_shape)) == before
    spmv.csr_spmv_launches_by_shape[(1, 2, 3)] += 1
    spmv.reset_launch_counts()
    assert not spmv.csr_spmv_launches_by_shape


def _empty_rows():
    # 3000 rows, about 70% empty, the others 1-90 entries
    rng = np.random.default_rng(11)
    n, m = 3000, 2500
    deg = np.where(rng.random(n) < 0.7, 0, rng.integers(1, 91, n))
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, len(rows))
    a = sps.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                       shape=(n, m)).tocsr()
    a.sum_duplicates()
    return a


def _one_row():
    rng = np.random.default_rng(12)
    cols = np.sort(rng.choice(50, 40, replace=False))
    return sps.csr_matrix((rng.standard_normal(40), (np.zeros(40, int), cols)),
                          shape=(1, 50))


TABLE_CASES = ([(name, cap) for name in MATRICES for cap in (64, 8)]
               + [("empty_rows", 64), ("one_row", 64)])


def _table_matrix(name):
    if name == "empty_rows":
        return _empty_rows()
    if name == "one_row":
        return _one_row()
    return _scipy(name)


def _lanes(rows, threads):
    """The k = 1 kernel's lanes a row in each block: the most (a power of
    two, at most 32) with which the block's rows take its threads
    once."""
    lanes = np.ones_like(rows)
    for _ in range(5):
        lanes[(lanes < 32) & (2 * lanes * rows <= threads)] *= 2
    return lanes


def _walk(table, entries, indptr, indices, data, x):
    """The row-block kernels' sums in their order, in numpy, for blocks
    of ``entries`` (entries / 4 threads).  k = 1: lane
    l of a row's L lanes sums terms l, l + L, ... in turn, then the
    shuffle tree halves the lanes; k > 1: each (row, column) sums its
    terms in turn."""
    start, length = indptr[:-1], np.diff(indptr)
    if x.ndim == 2:
        y = np.zeros((len(length), x.shape[1]))
        for t in range(length.max(initial=0)):
            r = np.flatnonzero(length > t)
            j = start[r] + t
            y[r] += data[j, None] * x[indices[j]]
        return y
    terms = data * x[indices]
    blocks = np.diff(table)
    lanes = np.repeat(_lanes(blocks, entries // 4), blocks)
    part = np.zeros((len(length), 32))
    for t in range(length.max(initial=0)):
        for lane in range(32):
            pos = lane + t * lanes
            r = np.flatnonzero((lane < lanes) & (pos < length))
            part[r, lane] += terms[start[r] + pos[r]]
    for off in (16, 8, 4, 2, 1):
        r = lanes > off
        part[r, :off] += part[r, off:2 * off]
    return part[:, 0]


# the sizes the row-block probe builds; K1's S (BLOCK_ENTRIES) is one
@pytest.mark.parametrize("max_entries", [256, 512, 1024, 2048])
@pytest.mark.parametrize("name,cap", TABLE_CASES)
def test_row_block_table(name, cap, max_entries):
    sp = _table_matrix(name)
    (ip, ix, v), (tr, tc, tv) = spmv.split_capped(sp.indptr, sp.indices,
                                                  sp.data, cap)
    table = spmv.row_blocks(ip, max_entries)
    assert table.dtype == np.int32
    # the blocks partition the rows, in order, at most S / 2 a block
    assert table[0] == 0 and table[-1] == sp.shape[0]
    assert np.all(np.diff(table) > 0)
    assert np.diff(table).max() <= max_entries // 2
    tensors = spmv.block_table(ip, "cpu", max_entries)
    np.testing.assert_array_equal(tensors["block_rows"].numpy(), table)
    np.testing.assert_array_equal(tensors["block_ptr"].numpy(), ip[table])
    if max_entries == spmv.BLOCK_ENTRIES:
        mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu",
                                      torch.float64, cap=cap)
        np.testing.assert_array_equal(mat.block_rows.numpy(), table)
        assert mat.n_blocks == len(table) - 1
    # each block's entries span at most max_entries / 4 aligned chunks
    e0, e1 = ip[table[:-1]], ip[table[1:]]
    assert np.all(e1 - e0 <= max_entries)
    assert np.all(-(-e1 // 4) - e0 // 4 <= max_entries // 4)
    # reducing each row in the kernels' order gives scipy's y
    for k in (1, 5):
        x = _x(sp.shape[1], k, np.float64, seed=k)
        y = _walk(table, max_entries, ip, ix, v, x)
        np.add.at(y, tr, tv[:, None] * x[tc] if k > 1 else tv * x[tc])
        ref = sp @ x
        np.testing.assert_allclose(y, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


def test_row_block_table_rejects():
    ip = np.array([0, 64, 64, 100])
    with pytest.raises(ValueError, match="does not fit"):
        spmv.row_blocks(ip, 64)
    with pytest.raises(ValueError):
        spmv.row_blocks(ip, 2046)
    assert list(spmv.row_blocks(np.array([0]))) == [0]


def test_row_block_sweep_cli_on_cpu(capsys):
    from tpu_amg_torch.tools import rowblocks

    records, on_path = rowblocks.run(["--device", "cpu", "--side", "12",
                                      "--fem-side", "16", "--reps", "1",
                                      "--entries", "256", "1024"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0] and "(12)" in lines[0]
    # the FEM matrix, then the SA path's levels 0-1 (1,728 rows: two
    # levels, so A0, P0, R0 and A1), each at k = 1: no launch is counted
    # on the CPU
    matrices = ["fem16", "A0", "P0", "R0", "A1"]
    assert len(lines) == 1 + len(matrices) + 1
    assert [r["matrix"] for r in records] == [m for m in matrices
                                              for _ in range(4)]
    assert [r["design"] for r in records[:4]] == ["rowgroup", "library",
                                                  "S=256", "S=1024"]
    sweep = [r for r in records if r["design"].startswith("S=")]
    assert all(r["err"] == 0.0 and r["blocks"] >= 1 for r in sweep)
    assert records[0]["dtype"] == "float32" and records[4]["dtype"] == "float64"
    assert on_path == {256: (0.0, 0.0), 1024: (0.0, 0.0)}


def test_probe_copies_are_separate():
    from tpu_amg_torch.tools import rowblocks

    sp = _scipy("rectangular")
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64)
    x = torch.from_numpy(_x(sp.shape[1], 1, np.float64))
    pairs = rowblocks.copies(mat, x, 3)
    assert pairs[0] == (mat, x) and len(pairs) == 3
    ptrs = {(m.data.data_ptr(), m.indices.data_ptr(), v.data_ptr())
            for m, v in pairs}
    assert len(ptrs) == 3
    for m, v in pairs[1:]:
        assert m.block_rows is mat.block_rows
        assert torch.equal(spmv.spmv(m, v), spmv.spmv(mat, x))


def test_library_must_match_the_tables():
    def row_block_entries():
        return 512

    dll = type("Lib", (), {"_name": "libk.so"})()
    dll.row_block_entries = row_block_entries
    spmv.check_block_entries(dll, 512)
    with pytest.raises(RuntimeError, match="compiled for row blocks of 512"):
        spmv.check_block_entries(dll)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [1, 7, 8, 64])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [1, 3, 7, 33])
@pytest.mark.parametrize("n,longest", [(1, 64), (255, 64), (257, 64),
                                       (1000, 64), (4099, 64), (3, 64),
                                       (1001, 2), (4097, 2), (2000, 1)])
def test_kernel_on_ragged_blocks_on_card(cuda, n, longest, k, dtype, tol):
    # row counts that are no multiple of a block, empty rows, rows of up
    # to the cap, and rows so short that blocks end at S / 2 rows
    rng = np.random.default_rng(n)
    deg = np.where(rng.random(n) < 0.2, 0, rng.integers(1, longest + 1, n))
    m = 3 * n + 5
    a = sps.csr_matrix((rng.standard_normal(deg.sum()),
                        rng.integers(0, m, deg.sum()),
                        np.r_[0, np.cumsum(deg)]), shape=(n, m))
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(a), cuda, dtype)
    x = torch.from_numpy(_x(m, k, np.float64)).to(cuda, dtype)
    before = spmv.csr_spmv_launches_by_shape[(n, m, k)]
    y = spmv.csr_spmv_capped(mat, x)
    ref = spmv.plain_csr_spmv_capped(mat, x)
    torch.cuda.synchronize()
    assert spmv.csr_spmv_launches_by_shape[(n, m, k)] == before + 1
    scale = max(float(ref.abs().max()), 1.0)
    assert float((y - ref).abs().max()) <= tol * scale
