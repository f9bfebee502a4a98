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


@pytest.mark.parametrize("built", [spmv.LONG_TAIL_ROW, 256])
def test_library_must_match_the_long_rows(built):
    dll = type("Lib", (), {"_name": "libk.so"})()
    dll.long_tail_row = lambda: built
    if built == spmv.LONG_TAIL_ROW:
        spmv.check_long_tail_row(dll)
    else:
        with pytest.raises(RuntimeError, match="long tail rows past 256"):
            spmv.check_long_tail_row(dll)


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


# (values, vectors, tolerance): the five pairs of spmv.PAIRS
PAIR_TOLS = [(torch.float64, torch.float64, 1e-12),
             (torch.float32, torch.float32, 1e-5),
             (torch.float32, torch.float64, 1e-12),
             (torch.bfloat16, torch.float32, 1e-5),
             (torch.bfloat16, torch.float64, 1e-12)]
# k = 1 and the k > 1 that the setup paths launch, with neighbours
CARD_KS = [1, 2, 3, 5, 7, 8, 11, 16, 17, 32, 33, 63, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype,dtype,tol", PAIR_TOLS)
@pytest.mark.parametrize("k", CARD_KS)
@pytest.mark.parametrize("n,longest", [(1, 64), (255, 64), (257, 64),
                                       (1000, 64), (4099, 64), (3, 64),
                                       (1001, 2), (4097, 2), (2000, 1)])
def test_kernel_on_ragged_blocks_on_card(cuda, n, longest, k, vdtype, dtype,
                                         tol):
    # row counts that are no multiple of a block, empty rows, rows of up
    # to the cap, and rows so short that blocks end at S / 2 rows; at
    # k > 1 the routed design bitwise the first SpMM design, two calls bitwise
    rng = np.random.default_rng(n)
    deg = np.where(rng.random(n) < 0.2, 0, rng.integers(1, longest + 1, n))
    m = 3 * n + 5
    a = sps.csr_matrix((rng.standard_normal(deg.sum()),
                        rng.integers(0, m, deg.sum()),
                        np.r_[0, np.cumsum(deg)]), shape=(n, m))
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(a), cuda, vdtype)
    x = torch.from_numpy(_x(m, k, np.float64)).to(cuda, dtype)
    before = spmv.csr_spmv_launches_by_shape[(n, m, k)]
    y = spmv.csr_spmv_capped(mat, x)
    again = spmv.csr_spmv_capped(mat, x)
    first = spmv.launch_first_spmm(mat, x)
    ref = spmv.plain_csr_spmv_capped(mat, x)
    torch.cuda.synchronize()
    assert spmv.csr_spmv_launches_by_shape[(n, m, k)] == before + 2
    assert torch.equal(y, again) and torch.equal(y, first)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((y - ref).abs().max()) <= tol * scale


def _hub_rows():
    # 2000 rows of 3-10 entries, and three hub rows of 1,000, 2,500 and
    # 5,000
    rng = np.random.default_rng(13)
    n, m = 2000, 6000
    deg = rng.integers(3, 11, n)
    deg[[5, 700, 1999]] = [1000, 2500, 5000]
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([np.sort(rng.choice(m, d, replace=False))
                           for d in deg])
    return sps.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                          shape=(n, m))


def _level2_like(n=3000, seed=14):
    # rows of 120-190 entries: about 90 past cap 64, as on the structured
    # path's level 2
    rng = np.random.default_rng(seed)
    deg = rng.integers(120, 191, n)
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                           for d in deg])
    return sps.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                          shape=(n, n))


def _random_csr(seed):
    rng = np.random.default_rng(seed)
    n, m = rng.integers(1, 400, 2)
    deg = rng.integers(0, 60, n)
    a = sps.csr_matrix((rng.standard_normal(deg.sum()),
                        rng.integers(0, m, deg.sum()),
                        np.r_[0, np.cumsum(deg)]), shape=(n, m))
    a.sum_duplicates()
    return a


# (name, matrix, cap): no tail; every row spilling; empty rows; a
# rectangular shape; one hub row of 5,000 entries; random CSRs and caps
TAIL_CASES = {
    "no_tail": (lambda: _scipy("random_banded"), 64),
    "all_spill": (lambda: _level2_like(300), 64),
    "empty_rows": (_empty_rows, 16),
    "rectangular": (lambda: _scipy("rectangular"), 4),
    "hub_row": (_hub_rows, 64),
    **{f"random{seed}": (lambda seed=seed: _random_csr(seed), cap)
       for seed, cap in ((0, 1), (1, 5), (2, 17), (3, 64))},
}


@pytest.mark.parametrize("name", list(TAIL_CASES))
def test_tail_row_table(name):
    make, cap = TAIL_CASES[name]
    sp = make()
    (_, _, _), (tr, tc, tv) = spmv.split_capped(sp.indptr, sp.indices,
                                                sp.data, cap)
    row_ids, ptr = spmv.tail_row_table(sp.indptr, cap)
    assert row_ids.dtype == np.int32 and ptr.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == len(tr) and len(ptr) == len(row_ids) + 1
    assert np.all(np.diff(row_ids) > 0) and np.all(np.diff(ptr) > 0)
    # the table reproduces split_capped's tail rows, entry by entry
    np.testing.assert_array_equal(np.repeat(row_ids, np.diff(ptr)), tr)
    np.testing.assert_array_equal(row_ids,
                                  np.flatnonzero(np.diff(sp.indptr) > cap))
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=cap)
    np.testing.assert_array_equal(mat.tail_row_ids.numpy(), row_ids)
    np.testing.assert_array_equal(mat.tail_ptr.numpy(), ptr)
    np.testing.assert_array_equal(mat.tail_rows().numpy(), tr)
    np.testing.assert_array_equal(mat.tail_cols.numpy(), tc)
    long_rows = mat.tail_long.numpy()
    np.testing.assert_array_equal(
        long_rows, np.flatnonzero(np.diff(ptr) > spmv.LONG_TAIL_ROW))
    assert mat.n_tail_rows == len(row_ids)
    if name == "no_tail":
        assert mat.n_tail == 0 and mat.n_tail_rows == 0
    if name == "all_spill":
        assert mat.n_tail_rows == sp.shape[0]
    if name == "hub_row":
        assert list(np.diff(ptr)[long_rows]) == [1000 - 64, 2500 - 64,
                                                 5000 - 64]


def _k2_walk(row_ids, ptr, long_rows, cols, vals, x, k, lanes):
    """K2's sums in the kernel's order, in numpy: a team of ``lanes``
    lanes a row (8 warps for the long rows), groups of G lanes, group q
    summing entries q, q + groups, ... in turn; the shuffle tree over a
    team's groups within a warp, then the warps in order."""
    x2 = x.reshape(len(x), -1)
    g_lanes = 1
    while g_lanes < k and g_lanes < 32:
        g_lanes *= 2
    out = np.zeros((len(row_ids), x2.shape[1]))
    is_long = np.zeros(len(row_ids), bool)
    is_long[long_rows] = True
    for i in range(len(row_ids)):
        warps, team = (8, 32) if is_long[i] else (1, lanes)
        per_warp = team // g_lanes
        groups = warps * per_warp
        e = np.arange(ptr[i], ptr[i + 1])
        part = np.zeros((groups, x2.shape[1]))
        for q in range(groups):
            for j in e[q::groups]:
                part[q] += vals[j] * x2[cols[j]]
        total = np.zeros(x2.shape[1])
        for w in range(warps):
            p = part[w * per_warp:(w + 1) * per_warp].copy()
            o = per_warp // 2
            while o >= 1:
                p[:per_warp - o] += p[o:]
                o //= 2
            total = p[0] if w == 0 else total + p[0]
        out[i] = total
    return out


def _valid_lanes(k):
    """The team widths K2 takes at k columns: 8, 16 and 32, no fewer
    than G (the power of two at or above k, at most 32)."""
    return [lanes for lanes in (8, 16, 32)
            if lanes >= min(32, 1 << (k - 1).bit_length())]


@pytest.mark.parametrize("n_rows,k,lanes", [
    (0, 1, 32), (2220, 1, 32), (6676, 1, 32), (8448, 1, 32), (8449, 1, 16),
    (15569, 1, 16), (17298, 1, 8), (10**6, 1, 8), (15569, 8, 32),
    (10**6, 64, 32)])
def test_k2_lanes(n_rows, k, lanes):
    # a warp a row while every row's warp is resident at once on 132 SMs
    # of 2048 threads (8448 warps); past that, at k = 1, 16 or 8 lanes
    assert spmv.k2_lanes(n_rows, k, 132) == lanes


@pytest.mark.parametrize("k", [1, 7, 8])
@pytest.mark.parametrize("name", list(TAIL_CASES))
def test_plain_k2_from_table_matches_scipy(name, k):
    make, cap = TAIL_CASES[name]
    sp = make()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=cap)
    (ip, ix, v), (tr, tc, tv) = spmv.split_capped(sp.indptr, sp.indices,
                                                  sp.data, cap)
    tail = sps.csr_matrix((tv, (tr, tc)), shape=sp.shape)
    x = _x(sp.shape[1], k, np.float64, seed=k)
    ref = tail @ x
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    y = torch.zeros(ref.shape, dtype=torch.float64)
    spmv.coo_patch(mat, torch.from_numpy(x), y)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-12 * scale)
    # the kernel's own order of sums, on the rows that spill, at K2's
    # team width and at the narrowest the kernel takes
    for lanes in sorted({_valid_lanes(k)[0],
                         spmv.k2_lanes(mat.n_tail_rows, k, 132), 32}):
        walk = _k2_walk(mat.tail_row_ids.numpy(), mat.tail_ptr.numpy(),
                        mat.tail_long.numpy(), tc, tv, x, k, lanes)
        np.testing.assert_allclose(walk, ref.reshape(len(ref), -1)[
            mat.tail_row_ids.numpy()], rtol=0, atol=1e-12 * scale)
    # and on top of K1 it gives the whole product
    full = spmv.spmv(mat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(full, sp @ x, rtol=0,
                               atol=1e-12 * max(np.abs(sp @ x).max(initial=0),
                                                1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype,dtype,tol", PAIR_TOLS)
@pytest.mark.parametrize("k", CARD_KS)
@pytest.mark.parametrize("name", ["hub_row", "all_spill", "level2",
                                  "rectangular", "empty_rows"])
def test_k2_matches_plain_on_card(cuda, name, k, vdtype, dtype, tol):
    # the routed design against the plain version and K2's rows design (a warp a
    # row), two calls bitwise equal
    if name == "level2":
        sp, cap = _level2_like(), 64
    else:
        make, cap = TAIL_CASES[name]
        sp = make()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), cuda, vdtype, cap=cap)
    x = torch.from_numpy(_x(sp.shape[1], k, np.float64)).to(cuda, dtype)
    y0 = torch.from_numpy(_x(sp.shape[0], k, np.float64, seed=5)).to(cuda,
                                                                      dtype)
    before = spmv.coo_patch_launches_by_shape[(*sp.shape, k)]
    y = y0.clone()
    spmv.coo_patch(mat, x, y)
    again = y0.clone()
    spmv.coo_patch(mat, x, again)
    ref = y0.clone()
    spmv.plain_coo_patch(mat, x, ref)
    rows = y0.clone()
    if mat.n_tail:
        spmv.launch_coo_patch(mat, x, rows, k, 32)
    torch.cuda.synchronize()
    assert spmv.coo_patch_launches_by_shape[(*sp.shape, k)] == before + 2
    assert torch.equal(y, again)  # one writer a row: the same bits
    scale = max(float(ref.abs().max()), 1.0)
    assert float((y - ref).abs().max()) <= tol * scale
    assert float((y - rows).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,lanes", [
    (name, k, lanes) for name in ("hub_row", "level2", "empty_rows")
    for k in (1, 8) for lanes in _valid_lanes(k)])
def test_k2_every_lanes_on_card(cuda, name, k, lanes):
    # K2 at each team width, not only the one k2_lanes picks: against the
    # plain version, and two calls bitwise equal
    if name == "level2":
        sp, cap = _level2_like(), 64
    else:
        make, cap = TAIL_CASES[name]
        sp = make()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), cuda, torch.float64,
                                  cap=cap)
    x = torch.from_numpy(_x(sp.shape[1], k, np.float64)).to(cuda)
    y0 = torch.from_numpy(_x(sp.shape[0], k, np.float64, seed=5)).to(cuda)
    y, again, ref = y0.clone(), y0.clone(), y0.clone()
    before = spmv.coo_patch_launches
    spmv.launch_coo_patch(mat, x, y, k, lanes)
    spmv.launch_coo_patch(mat, x, again, k, lanes)
    spmv.plain_coo_patch(mat, x, ref)
    torch.cuda.synchronize()
    assert spmv.coo_patch_launches == before  # measurement launches
    assert torch.equal(y, again)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((y - ref).abs().max()) <= 1e-12 * scale


def test_k2_launcher_refuses_cpu_tensors():
    sp = _hub_rows()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64)
    x = torch.zeros(sp.shape[1], dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no kernel"):
        spmv.launch_coo_patch(mat, x, torch.zeros(sp.shape[0],
                                                  dtype=torch.float64), 1, 32)


def _block_matrix(n_brows=300, bs=6, seed=11):
    """A square block-sparse CSR of full bs x bs blocks, about 14 blocks a
    block row: its scalar rows (~84 entries) pass the cap of 64."""
    rng = np.random.default_rng(seed)
    br = np.repeat(np.arange(n_brows), 14)
    bc = np.clip(br + rng.integers(-20, 21, br.size), 0, n_brows - 1)
    r = (br[:, None, None] * bs + np.arange(bs)[None, :, None]).repeat(bs, 2)
    c = (bc[:, None, None] * bs + np.arange(bs)[None, None, :]).repeat(bs, 1)
    n = n_brows * bs
    return CSR.from_coo(r.ravel(), c.ravel(), rng.standard_normal(r.size),
                        (n, n), block_size=bs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("fmt", ["ELL", "BSR"])
def test_containers_apply_through_k1_k2_on_card(cuda, fmt, k, dtype, tol):
    # an ELL or a BSR applies through its capped CSR: K1, K2 on the tail,
    # the plain version's result, the CSR operator's bits
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.sparse import BSR, ELL

    csr = _block_matrix()
    mat = (ELL if fmt == "ELL" else BSR).from_csr(csr, cuda, dtype=dtype)
    assert mat.capped.n_tail > 0
    x = torch.from_numpy(_x(csr.ncols, k, np.float64)).to(cuda, dtype)
    launches = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    y = mat(x)
    torch.cuda.synchronize()
    assert (spmv.csr_spmv_launches, spmv.coo_patch_launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = spmv.plain_spmv(mat.capped, x)
    assert float((y - ref).abs().max()) <= tol * float(ref.abs().max())
    op = SparseOperator.from_csr(csr, cuda, dtype, prefer_dia=False)
    assert torch.equal(y, op.mv(x) if k == 1 else op.mm(x))
