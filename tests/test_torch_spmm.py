"""K1's and K2's many-column designs: the staged SpMM and the K2 pieces.

On the CPU: the host tables the kernels read (``spmv.spmm_blocks``,
``spmv.k2_pieces``) on the matrices of ``tests/test_torch_spmv.py``,
K1's router (a pure function of the bytes of an X row and the mean
capped row length), and K2's piece order of sums restated in numpy
against the plain version.  The CUDA cases (the staged SpMM bitwise
equal to the first SpMM design, the pieces within tolerance of K2's rows
design and of the plain versions, at every k the paths launch and the
five (values, vectors) pairs) are in ``tests/test_torch_spmv.py``
(``test_kernel_on_ragged_blocks_on_card``, ``test_k2_matches_plain_on_card``)
and here, marked ``cuda``.

The module imports no JAX.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from test_torch_spmv import (MATRICES, TAIL_CASES, _level2_like,
                             _table_matrix, _x)
from tpu_amg_torch.ops import spmv
from tpu_amg_torch.sparse.csr import CSR

# the k > 1 that the paths launch (the SA bootstrap 7 and 8, its ||E||_A 5,
# elasticity 11, adaptive and classical 63 and 64) and their neighbours
PATH_KS = (2, 3, 5, 7, 8, 11, 16, 17, 32, 33, 63, 64)


def _wide_rows(n=400, seed=21):
    # rows of 40-64 entries over 20,000 columns: hardly a column repeats,
    # so blocks are cut for the 128 staged X rows, not for 512 entries
    rng = np.random.default_rng(seed)
    deg = rng.integers(40, 65, n)
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([np.sort(rng.choice(20000, d, replace=False))
                           for d in deg])
    return sps.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                          shape=(n, 20000))


SPMM_CASES = ([(name, cap) for name in MATRICES for cap in (64, 8)]
              + [("empty_rows", 64), ("one_row", 64), ("wide_rows", 64)])
# (entries, rows, distinct columns) a block: the library's, and a small
# budget that cuts most blocks for their columns
BUDGETS = [(spmv.SPMM_ENTRIES, spmv.SPMM_ROWS, spmv.SPMM_COLUMNS),
           (64, 16, 8)]


def _spmm_matrix(name):
    return _wide_rows() if name == "wide_rows" else _table_matrix(name)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name,cap", SPMM_CASES)
def test_spmm_table(name, cap, budget):
    max_entries, max_rows, max_cols = budget
    if cap > max_cols:
        cap = max_cols
    sp = _spmm_matrix(name)
    (ip, ix, _), _ = spmv.split_capped(sp.indptr, sp.indices, sp.data, cap)
    t = spmv.spmm_blocks(ip, ix, max_entries, max_rows, max_cols)
    rows, col_ptr, cols, slots = t["rows"], t["col_ptr"], t["cols"], t["slots"]
    assert rows.dtype == col_ptr.dtype == cols.dtype == np.int32
    assert slots.dtype == np.int16 and len(slots) == len(ix)
    # the blocks partition the rows in order, within the budget
    assert rows[0] == 0 and rows[-1] == sp.shape[0]
    assert np.all(np.diff(rows) > 0) and np.diff(rows).max() <= max_rows
    lens = ip[rows[1:]] - ip[rows[:-1]]
    assert lens.max() <= max_entries
    # each block's distinct columns listed once, increasing, in budget
    width = np.diff(col_ptr)
    assert col_ptr[0] == 0 and col_ptr[-1] == len(cols)
    assert width.max() <= max_cols and t["width"] == width.max()
    blk = np.repeat(np.arange(len(rows) - 1), lens)
    for b in range(len(rows) - 1):
        mine = cols[col_ptr[b]:col_ptr[b + 1]]
        np.testing.assert_array_equal(mine, np.unique(ix[blk == b]))
    # every entry's slot maps back to its column
    assert slots.min(initial=0) >= 0 and np.all(slots < width[blk])
    np.testing.assert_array_equal(cols[col_ptr[blk] + slots], ix)
    if name == "wide_rows":
        # cut for the staged rows: more blocks than entries alone need
        assert len(rows) - 1 > -(-len(ix) // max_entries)
        assert width.max() > max_cols // 2


def test_spmm_table_on_the_matrix():
    sp = _wide_rows()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64)
    t = spmv.spmm_blocks(mat.indptr.numpy(), mat.indices.numpy())
    np.testing.assert_array_equal(mat.spmm_rows.numpy(), t["rows"])
    np.testing.assert_array_equal(mat.spmm_col_ptr.numpy(), t["col_ptr"])
    np.testing.assert_array_equal(mat.spmm_cols.numpy(), t["cols"])
    np.testing.assert_array_equal(mat.spmm_slots.numpy(), t["slots"])
    assert mat.spmm_width == t["width"]
    assert mat.n_spmm_blocks == len(t["rows"]) - 1
    # a precision cast shares every table
    cast = mat.astype(torch.float32)
    assert cast.spmm_slots is mat.spmm_slots
    assert cast.piece_ptr is mat.piece_ptr
    assert mat.table_bytes() == sum(
        a.nbytes for a in (t["rows"], t["col_ptr"], t["cols"], t["slots"])
    ) + 4 * (mat.piece_rows.numel() + mat.piece_ptr.numel()
             + mat.piece_row.numel() + mat.piece_blocks.numel())


def test_spmm_table_rejects_a_row_past_the_columns():
    ip = np.array([0, 10, 30])
    with pytest.raises(ValueError, match="does not fit"):
        spmv.spmm_blocks(ip, np.arange(30), 512, 64, 16)
    empty = spmv.spmm_blocks(np.array([0]), np.zeros(0, np.int32))
    assert list(empty["rows"]) == [0] and empty["width"] == 0


@pytest.mark.parametrize("name", list(TAIL_CASES) + ["level2"])
def test_k2_piece_table(name):
    if name == "level2":
        sp, cap = _level2_like(), 64
    else:
        make, cap = TAIL_CASES[name]
        sp = make()
    row_ids, ptr = spmv.tail_row_table(sp.indptr, cap)
    t = spmv.k2_pieces(ptr, row_ids)
    row_piece, piece_ptr, blocks = t["row_piece"], t["piece_ptr"], t["blocks"]
    assert row_piece.dtype == piece_ptr.dtype == blocks.dtype == np.int32
    assert t["piece_row"].dtype == np.int32
    lens = np.diff(ptr)
    # the pieces cover every tail entry once, in order, none empty
    assert piece_ptr[0] == 0 and piece_ptr[-1] == ptr[-1]
    assert np.all(np.diff(piece_ptr) > 0)
    assert len(piece_ptr) == row_piece[-1] + 1
    # each row's pieces start at its tail and end at the next row's
    np.testing.assert_array_equal(piece_ptr[row_piece], ptr)
    n_pieces = np.diff(row_piece)
    assert np.all(n_pieces >= 1) and n_pieces.max(initial=1) <= spmv.K2_BUCKET
    size = np.diff(piece_ptr)
    row_of = np.repeat(np.arange(len(lens)), n_pieces)
    short = lens[row_of] <= spmv.K2_PIECE * spmv.K2_BUCKET
    assert np.all(size[short] <= spmv.K2_PIECE)
    # a row of one piece names its row of Y there, the others -1
    np.testing.assert_array_equal(
        t["piece_row"], np.where(n_pieces == 1, row_ids, -1)[row_of])
    # the blocks partition the rows, fewer than 2 buckets of pieces each,
    # each beside its first piece
    first_row, first_piece = blocks[:, 0], blocks[:, 1]
    assert first_row[0] == 0 and first_row[-1] == len(lens)
    assert np.all(np.diff(first_row) > 0) or len(lens) == 0
    np.testing.assert_array_equal(first_piece, row_piece[first_row])
    assert np.diff(first_piece).max(initial=0) < 2 * spmv.K2_BUCKET
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=cap)
    np.testing.assert_array_equal(mat.piece_rows.numpy(), row_piece)
    np.testing.assert_array_equal(mat.piece_ptr.numpy(), piece_ptr)
    np.testing.assert_array_equal(mat.piece_row.numpy(), t["piece_row"])
    np.testing.assert_array_equal(mat.piece_blocks.numpy(), blocks)
    if name == "hub_row":
        # the 1,000-, 2,500- and 5,000-entry rows: a bucket of longer pieces
        assert list(n_pieces[lens > 600]) == [spmv.K2_BUCKET] * 3
    if name == "all_spill":
        # rows of 56-126 tail entries: one piece or two
        assert set(n_pieces) <= {1, 2} and 1 in set(n_pieces)


def test_router_by_row_bytes_and_row_length():
    short, mean = spmv.SPMM_SHORT_ROWS, spmv.SPMM_SHORT_ROWS + 0.1
    for itemsize in (8, 4):
        assert spmv.k1_design(1, itemsize, 3.0) == "spmv"
        for k in range(2, spmv.MAX_COLUMNS + 1):
            row = k * itemsize
            if row >= spmv.SPMM_GATHER_ROW:
                want = ("gather", "gather")
            elif row <= spmv.SPMM_STAGE_ROW:
                want = ("staged", "first")
            else:
                want = ("first", "first")
            assert (spmv.k1_design(k, itemsize, short),
                    spmv.k1_design(k, itemsize, mean)) == want
    # f64: staged up to k = 8 on short rows, the gather mode from 32
    assert [spmv.k1_design(k, 8, 8.4) for k in (5, 8, 9, 31, 32, 64)] == [
        "staged", "staged", "first", "first", "gather", "gather"]
    # f32: staged up to 16, the gather mode at 64 alone
    assert [spmv.k1_design(k, 4, 8.4) for k in (16, 17, 63, 64)] == [
        "staged", "first", "first", "gather"]
    # the mean capped row length the wrapper reads: capped entries / rows
    sp = _wide_rows()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=16)
    assert mat.row_mean == 16.0
    assert spmv.k1_design(5, 8, mat.row_mean) == "first"
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=8)
    assert mat.row_mean == 8.0
    assert spmv.k1_design(5, 8, mat.row_mean) == "staged"


def _team(k, vec=2):
    team = 1
    while team * vec < k and team < 32:
        team *= 2
    return team


def _pieces_walk(mat, x, y0):
    """K2's piece design in numpy, in the kernel's order of sums: group q
    of a warp (32 / team groups) sums entries q, q + groups, ... of a
    piece in turn; the groups meet by the shuffle tree o = 16, ..., team
    (lanes, so groups o / team apart); a row's pieces are summed in
    piece order and added into y once."""
    k = x.shape[1]
    groups = 32 // _team(k)
    row_piece = mat.piece_rows.numpy()
    piece_ptr = mat.piece_ptr.numpy()
    cols, vals = mat.tail_cols.numpy(), mat.tail_vals.numpy()
    n_p = len(piece_ptr) - 1
    part = np.zeros((n_p, groups, k))
    size = np.diff(piece_ptr)
    for t in range(-(-size.max(initial=0) // groups)):
        for q in range(groups):
            pos = q + t * groups
            p = np.flatnonzero(pos < size)
            j = piece_ptr[p] + pos
            part[p, q] += vals[j, None] * x[cols[j]]
    o = groups // 2
    while o >= 1:
        part[:, :o] += part[:, o:2 * o]
        o //= 2
    piece_sum = part[:, 0]
    y = y0.copy()
    for i, row in enumerate(mat.tail_row_ids.numpy()):
        s = piece_sum[row_piece[i]].copy()
        for p in range(row_piece[i] + 1, row_piece[i + 1]):
            s += piece_sum[p]
        y[row] += s
    return y


@pytest.mark.parametrize("k", [2, 7, 33, 64])
@pytest.mark.parametrize("name", ["hub_row", "all_spill", "empty_rows",
                                  "rectangular", "random1"])
def test_k2_piece_order_matches_plain(name, k):
    make, cap = TAIL_CASES[name]
    sp = make()
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), "cpu", torch.float64,
                                  cap=cap)
    x = _x(sp.shape[1], k, np.float64, seed=k)
    y0 = _x(sp.shape[0], k, np.float64, seed=5)
    ref = torch.from_numpy(y0.copy())
    spmv.plain_coo_patch(mat, torch.from_numpy(x), ref)
    walk = _pieces_walk(mat, x, y0)
    scale = max(float(ref.abs().max()), 1.0)
    np.testing.assert_allclose(walk, ref.numpy(), rtol=0, atol=1e-12 * scale)


# (values, vectors, tolerance relative to the largest |y|)
PAIR_TOLS = [(torch.float64, torch.float64, 1e-12),
             (torch.float32, torch.float32, 1e-5),
             (torch.float32, torch.float64, 1e-12),
             (torch.bfloat16, torch.float32, 1e-5),
             (torch.bfloat16, torch.float64, 1e-12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vdtype,dtype,tol", PAIR_TOLS)
@pytest.mark.parametrize("k", PATH_KS)
@pytest.mark.parametrize("name", ["wide_rows", "heavy_rows", "rectangular",
                                  "clustered_heavy_rows"])
def test_staged_designs_on_card(cuda, name, k, vdtype, dtype, tol):
    # the wrapper's route, counted by design; the staged SpMM (in the
    # mode the bytes of an X row give) bitwise the first design's at any
    # k, K2's pieces within tolerance of the rows design's
    sp = _spmm_matrix(name)
    mat = spmv.CappedCSR.from_csr(CSR.from_scipy(sp), cuda, vdtype, cap=16)
    x = torch.from_numpy(_x(sp.shape[1], k, np.float64)).to(cuda, dtype)
    y0 = torch.from_numpy(_x(sp.shape[0], k, np.float64, seed=5)).to(cuda,
                                                                      dtype)
    k1 = dict(spmv.csr_spmv_launches_by_design)
    y = spmv.csr_spmv_capped(mat, x)
    first = spmv.launch_first_spmm(mat, x)
    staged = spmv.launch_staged_spmm(mat, x)
    patched, rows, ref = y0.clone(), y0.clone(), y0.clone()
    spmv.coo_patch(mat, x, patched)
    spmv.launch_coo_patch(mat, x, rows, k, 32)
    spmv.plain_coo_patch(mat, x, ref)
    plain = spmv.plain_csr_spmv_capped(mat, x)
    torch.cuda.synchronize()
    design = spmv.k1_design(k, x.element_size(), mat.row_mean)
    assert spmv.csr_spmv_launches_by_design[design] == k1.get(design, 0) + 1
    assert torch.equal(first, staged) and torch.equal(y, staged)
    scale = max(float(plain.abs().max()), 1.0)
    assert float((staged - plain).abs().max()) <= tol * scale
    if mat.n_tail:
        again = y0.clone()
        spmv.launch_coo_pieces(mat, x, again, k)
        torch.cuda.synchronize()
        assert torch.equal(patched, again)
        scale = max(float(ref.abs().max()), 1.0)
        assert float((patched - ref).abs().max()) <= tol * scale
        assert float((patched - rows).abs().max()) <= tol * scale


def test_tablecost_counts_the_builds(capsys):
    # tools.tablecost on the CPU at a small SA setup: every capped matrix
    # of the setup builds both tables once, inside the setup's seconds
    from tpu_amg_torch.tools import tablecost

    assert tablecost.main(["--device", "cpu", "--setups", "sa",
                           "--sa-side", "8"]) == 0
    out = capsys.readouterr().out.split()
    builds = int(out[out.index("builds") - 1])
    assert out[0] == "sa:" and builds > 0 and builds % 2 == 0
    assert float(out[out.index("the") + 2]) <= float(out[out.index("setup") + 1])
