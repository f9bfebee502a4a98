"""Sparse apply of a CSR matrix on the device: K1 + K2.

K1 ``csr_spmv_capped`` computes Y = A_cap X over the first ``cap``
entries of each CSR row; K2 ``coo_patch`` adds the entries of rows
longer than ``cap`` (the tail) into Y.  Together they give y = A x, and
Y = A X for a row-major X of shape (n, k) with k <= 64 (the bootstrap
smooths k = near-null dim - 1 candidates at once).  A may be square or
rectangular.

- K1 replaces the WELL SpMV Pallas kernel
  (``tpu_amg/ops/well_pallas.py::_kernel``, launched by
  ``_well_spmv_call``); K2 replaces its stray-patch kernel
  (``tpu_amg/ops/well_pallas.py::_stray_kernel``).  The split is the
  same: a row-length capped main kernel plus a patch for what spills.
- Both are bound by bytes (values + indices + gathered x + y), not by
  operations.  K1 is a row-block streaming kernel (CUDA C++ in
  ``tpu_amg_torch/csrc/csr_rowblock.cuh``, instantiated by
  ``csrc/spmv.cu``): :func:`row_blocks` cuts the rows once, on the
  host, into blocks of at most ``BLOCK_ENTRIES`` entries and half as
  many rows; one thread block streams a row block's
  entries in coalesced loads, stages the products in shared memory and
  reduces its rows from there.  K2 is a segmented row reduction over the
  tail, which keeps CSR order: :func:`tail_row_table` lists once, on the
  host, the rows that spill and where each one's tail starts; a team
  of :func:`k2_lanes` lanes owns such a row (a block of 8 warps a row
  of more than ``LONG_TAIL_ROW`` tail entries), sums it in a fixed
  order and adds it into Y: one writer a row, no atomics.
- At k > 1 each has a second design.  K2 runs its pieces at every k >
  1: tail pieces of up to ``K2_PIECE`` entries, a warp each
  (:func:`k2_pieces`), with 16-byte column vectors, where the first K2
  design (:func:`launch_coo_patch`, the reference on the card) walks a
  row a warp; the two agree to rounding.  K1 is routed by the bytes of
  an X row and the matrix's mean capped row length (:func:`k1_design`):
  the staged SpMM (``csrc/csr_spmm.cuh``), on its own row blocks (the
  table of :func:`spmm_blocks`, built here with the matrix), copies
  each block's distinct X rows into shared memory once ("staged", X
  rows of at most ``SPMM_STAGE_ROW`` bytes, rows of at most
  ``SPMM_SHORT_ROWS`` entries on average) or reads them through L1
  ("gather", X rows of at least ``SPMM_GATHER_ROW`` bytes), 16 bytes a
  lane either way; elsewhere the first SpMM design (one 8-byte column a
  lane, a pass a 32 columns; :func:`launch_first_spmm`, the reference
  on the card) runs.  The designs give the same bits.  What bounds
  them: the bytes each once, and past them the X rows gathered,
  nnz·k·itemsize for the first designs (an X row an entry).
- ``cap`` defaults to 64: at that cap the hub rows of a smoothed-SA
  restriction (a few hundred entries) spill, so K2 runs on the main
  path.  :func:`split_capped` makes the split once, when an operator is
  built.

Values (``data``, ``tail_vals``) are of a type V no wider than T, the
type of X and Y: the pairs (V, T) of ``PAIRS``, (f64, f64), (f32, f32),
(f32, f64), (bf16, f32) and (bf16, f64).  The kernels widen each value
exactly to T and multiply and sum in T, as the TPU's K1 reads a bf16
value stream under f32 vectors (``well_pallas.py:112``).  Any other
pair raises: the operators (:mod:`tpu_amg_torch.linop`) bring x to a
pair first (x widened to V where V is wider; x widened to f32 and y
rounded once where both are bf16, :mod:`tpu_amg_torch.precision`).

Each kernel has a plain PyTorch version beside it (gather ``x[cols] *
vals`` with the values widened to T, then ``index_add_`` over rows).  A
wrapper takes the plain version only when its tensors lie on the CPU;
for a CUDA tensor it launches the kernel or raises.  Each wrapper counts
its launches in a module integer (``csr_spmv_launches``,
``coo_patch_launches``), by (rows, cols, k) in
``csr_spmv_launches_by_shape`` and ``coo_patch_launches_by_shape``, by
(V, T) in ``csr_spmv_launches_by_dtype`` and
``coo_patch_launches_by_dtype``, and K1's by design in
``csr_spmv_launches_by_design``.

The kernels are compiled with nvcc for ``sm_90a`` into
``build/tpu_amg_torch/libamg_kernels.so`` at first launch and loaded
with ctypes.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops._build import build_cuda_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spmv.cu"
DEFAULT_CAP = 64
MAX_COLUMNS = 64
# K1's row blocks: S entries and S / 2 rows at most; the kernel library is
# compiled for this S (ROWBLOCK_ENTRIES in csrc/csr_rowblock.cuh: S / 4
# threads, 4 entries each).  Chosen by tools/rowblocks.py on the SA path's
# own matrices (PERF.md).
BLOCK_ENTRIES = 256
# K2: a tail row of more entries than this (a warp's step of loads at
# k = 1: 4 entries a lane) takes a block of 8 warps; the library is
# compiled for it (kLongTailRow in csrc/spmv.cu)
LONG_TAIL_ROW = 128
# K2 takes teams of no fewer lanes a tail row than this (k2_lanes)
K2_MIN_LANES = 8
# K1's routes at k > 1 (k1_design, from both designs timed on the paths'
# own matrices in chip_smoke.py; PERF.md): the staged SpMM with X rows
# copied into shared memory where an X row is at most SPMM_STAGE_ROW
# bytes and the capped rows average at most SPMM_SHORT_ROWS entries; the
# staged SpMM reading X rows through L1 (the gather mode) where an X row
# is at least SPMM_GATHER_ROW bytes; else the first SpMM design.
SPMM_STAGE_ROW = 64
SPMM_SHORT_ROWS = 14
SPMM_GATHER_ROW = 256
# K1's staged SpMM table (spmm_blocks): entries, rows and distinct
# columns (X rows staged in shared memory) a block, at most; K2's piece
# table (k2_pieces): tail entries a piece, pieces a bucket.  The library
# is compiled for the same (spmm_design in csrc/spmv.cu).
SPMM_ENTRIES = 512
SPMM_ROWS = 64
SPMM_COLUMNS = 128
K2_PIECE = 64
K2_BUCKET = 8
THREADS_PER_SM = 2048  # resident on a Hopper SM
_INT32_MAX = 2**31 - 1

csr_spmv_launches = 0
coo_patch_launches = 0
csr_spmv_launches_by_shape = collections.Counter()
coo_patch_launches_by_shape = collections.Counter()
csr_spmv_launches_by_dtype = collections.Counter()  # (V, T) -> launches
coo_patch_launches_by_dtype = collections.Counter()
# K1's design -> launches: "spmv" (k = 1), "first", "staged", "gather"
# (k1_design)
csr_spmv_launches_by_design = collections.Counter()

# (value type V, vector type T) -> the entry points' suffix
PAIRS = {
    (torch.float64, torch.float64): "f64",
    (torch.float32, torch.float32): "f32",
    (torch.float32, torch.float64): "f32f64",
    (torch.bfloat16, torch.float32): "bf16f32",
    (torch.bfloat16, torch.float64): "bf16f64",
}


def reset_launch_counts() -> None:
    global csr_spmv_launches, coo_patch_launches
    csr_spmv_launches = 0
    coo_patch_launches = 0
    for counts in (csr_spmv_launches_by_shape, coo_patch_launches_by_shape,
                   csr_spmv_launches_by_dtype, coo_patch_launches_by_dtype,
                   csr_spmv_launches_by_design):
        counts.clear()


def k1_design(k: int, itemsize: int, row_mean: float) -> str:
    """K1's design at k columns of ``itemsize`` bytes on a matrix whose
    capped rows hold ``row_mean`` entries on average: "spmv" at k = 1;
    the staged SpMM with X rows in shared memory ("staged") where an X
    row is at most ``SPMM_STAGE_ROW`` bytes and ``row_mean`` at most
    ``SPMM_SHORT_ROWS``; the staged SpMM reading X rows through L1
    ("gather") where an X row is at least ``SPMM_GATHER_ROW`` bytes;
    else the first SpMM design ("first")."""
    if k == 1:
        return "spmv"
    row = k * itemsize
    if row >= SPMM_GATHER_ROW:
        return "gather"
    if row <= SPMM_STAGE_ROW and row_mean <= SPMM_SHORT_ROWS:
        return "staged"
    return "first"


def pair_suffix(value_dtype: torch.dtype, dtype: torch.dtype) -> str:
    """The entry points' suffix for values of ``value_dtype`` under
    vectors of ``dtype``; raises for a pair no kernel takes."""
    try:
        return PAIRS[(value_dtype, dtype)]
    except KeyError:
        raise TypeError(f"no kernel for {value_dtype} values under {dtype} "
                        f"vectors (pairs: {sorted(PAIRS.values())})") from None


def check_block_entries(dll: ctypes.CDLL, entries: int = BLOCK_ENTRIES):
    """Raise unless the library ``dll`` was compiled for row blocks of
    ``entries``."""
    dll.row_block_entries.restype = ctypes.c_int
    built = dll.row_block_entries()
    if built != entries:
        raise RuntimeError(f"{dll._name} is compiled for row blocks of "
                           f"{built} entries, the tables are cut for {entries}")


def check_long_tail_row(dll: ctypes.CDLL):
    """Raise unless the library ``dll`` takes K2's long rows past
    ``LONG_TAIL_ROW`` entries, as the host lists them."""
    dll.long_tail_row.restype = ctypes.c_int
    built = dll.long_tail_row()
    if built != LONG_TAIL_ROW:
        raise RuntimeError(f"{dll._name} takes long tail rows past {built} "
                           f"entries, the tables list those past "
                           f"{LONG_TAIL_ROW}")


SPMM_DESIGN = (("entries", SPMM_ENTRIES), ("rows", SPMM_ROWS),
               ("columns", SPMM_COLUMNS), ("piece", K2_PIECE),
               ("bucket", K2_BUCKET))


def check_spmm_design(dll: ctypes.CDLL):
    """Raise unless the library ``dll`` was compiled for the staged SpMM
    and piece tables the host cuts (``SPMM_DESIGN``)."""
    dll.spmm_design.restype = ctypes.c_int
    dll.spmm_design.argtypes = [ctypes.c_int]
    built = {name: dll.spmm_design(i)
             for i, (name, _) in enumerate(SPMM_DESIGN)}
    if built != dict(SPMM_DESIGN):
        raise RuntimeError(f"{dll._name} is compiled for the SpMM tables "
                           f"{built}, the host cuts {dict(SPMM_DESIGN)}")


def bind_kernel_lib(path: Path, entries: int = BLOCK_ENTRIES) -> ctypes.CDLL:
    """Load a build of ``spmv.cu`` compiled for row blocks of
    ``entries`` and declare its entry points."""
    dll = ctypes.CDLL(str(path))
    check_block_entries(dll, entries)
    check_long_tail_row(dll)
    check_spmm_design(dll)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in PAIRS.values():
        fn = getattr(dll, f"csr_spmv_capped_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"coo_patch_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
        fn = getattr(dll, f"csr_spmm_staged_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp,
                       vp, vp]
        fn = getattr(dll, f"coo_patch_pieces_{suffix}")
        fn.restype = i32
        fn.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    dll.kernel_error_string.restype = ctypes.c_char_p
    dll.kernel_error_string.argtypes = [i32]
    return dll


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    """The kernel library, compiled with nvcc on first call."""
    return bind_kernel_lib(build_cuda_library("libamg_kernels.so", SOURCE))


def split_capped(indptr, indices, data, cap: int):
    """Split a CSR into (capped CSR, tail COO) on the host.

    The capped part keeps the first ``cap`` entries of each row; the
    tail holds the rest as (rows, cols, vals).  Capped part plus tail
    equals the whole matrix."""
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    n = len(deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    rank = np.arange(len(rows), dtype=np.int64) - indptr[:-1][rows]
    head = rank < cap
    cap_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.minimum(deg, cap), out=cap_indptr[1:])
    tail = ~head
    return (
        (cap_indptr, indices[head], data[head]),
        (rows[tail], indices[tail], data[tail]),
    )


def tail_row_table(indptr, cap: int):
    """K2's tail row table: the rows longer than ``cap`` (int32,
    increasing) and where each one's tail starts in the tail arrays of
    :func:`split_capped` (int32, one more entry than there are such
    rows)."""
    spill = np.diff(np.asarray(indptr, dtype=np.int64)) - cap
    row_ids = np.flatnonzero(spill > 0)
    ptr = np.zeros(len(row_ids) + 1, dtype=np.int64)
    np.cumsum(spill[row_ids], out=ptr[1:])
    if ptr[-1] > _INT32_MAX:
        raise ValueError(f"a tail of {ptr[-1]} entries passes 32-bit offsets")
    return row_ids.astype(np.int32), ptr.astype(np.int32)


def k2_lanes(n_rows: int, k: int, sms: int) -> int:
    """K2's lanes a tail row for a tail of ``n_rows`` rows at k columns
    on a card of ``sms`` SMs: a warp, or at k = 1 half as many, down to
    ``K2_MIN_LANES``, while the rows' teams would not all be resident at
    once (chosen on both paths' tails, PERF.md)."""
    lanes = 32
    while (k == 1 and lanes > K2_MIN_LANES
           and n_rows * lanes > sms * THREADS_PER_SM):
        lanes //= 2
    return lanes


def k2_pieces(tail_ptr, row_ids, piece: int = K2_PIECE,
              bucket: int = K2_BUCKET):
    """K2's piece table for the many-column design, from the tail row
    table (``tail_ptr``, ``row_ids``): ``row_piece`` (int32, rows + 1:
    each tail row's first piece), ``piece_ptr`` (int32, pieces + 1: each
    piece's first tail entry), ``piece_row`` (int32, a piece: the row of
    Y of a row cut into this one piece, else -1) and ``blocks`` (int32,
    (blocks + 1, 2): each block's first tail row and first piece).  A
    row of L entries is cut into min(ceil(L / piece), bucket) pieces of
    ceil(L / pieces) entries (the last shorter); a block holds the rows
    whose first piece falls in one bucket of ``bucket`` pieces, so fewer
    than 2 · bucket pieces."""
    ptr = np.asarray(tail_ptr, dtype=np.int64)
    lens = np.diff(ptr)  # every tail row has an entry
    n_pieces = np.minimum(-(-lens // piece), bucket)
    plen = -(-lens // n_pieces)
    row_piece = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(n_pieces, out=row_piece[1:])
    row_of = np.repeat(np.arange(len(lens)), n_pieces)
    at = np.arange(row_piece[-1]) - row_piece[row_of]
    piece_ptr = np.r_[ptr[row_of] + at * plen[row_of], ptr[-1]]
    piece_row = np.where(n_pieces[row_of] == 1,
                         np.asarray(row_ids, dtype=np.int64)[row_of], -1)
    first = row_piece[:-1] // bucket
    starts = np.flatnonzero(np.r_[True, first[1:] != first[:-1]])
    rows = np.r_[starts, len(lens)] if len(lens) else np.zeros(1, np.int64)
    return dict(row_piece=row_piece.astype(np.int32),
                piece_ptr=piece_ptr.astype(np.int32),
                piece_row=piece_row.astype(np.int32),
                blocks=np.stack([rows, row_piece[rows]], 1).astype(np.int32))


def spmm_blocks(cap_indptr, indices, max_entries: int = SPMM_ENTRIES,
                max_rows: int = SPMM_ROWS, max_cols: int = SPMM_COLUMNS):
    """K1's staged SpMM table: ``rows`` (int32, blocks + 1), block b
    holding rows ``rows[b]`` to ``rows[b + 1]``, at most ``max_entries``
    entries and ``max_rows`` rows; ``col_ptr`` (int32, blocks + 1) and
    ``cols`` (int32): block b's distinct columns, increasing, are
    ``cols[col_ptr[b]:col_ptr[b + 1]]``, at most ``max_cols`` of them;
    ``slots`` (int16, one a capped entry): each entry's place in its
    block's list; ``width``: the most distinct columns of a block.

    Rows go to buckets by their first entry (as :func:`row_blocks`), cut
    every ``max_rows`` rows; a block of more distinct columns than
    ``max_cols`` is then halved at the row nearest its middle entry,
    again until every block fits (a row alone fits: its length is at
    most the cap).  The entries are sorted once."""
    indptr = np.asarray(cap_indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    n = len(indptr) - 1
    longest = int(np.diff(indptr).max()) if n else 0
    if longest > min(max_entries, max_cols) or max_cols > 2**15:
        raise ValueError(f"a row of {longest} entries does not fit a staged "
                         f"block of {max_entries} entries, {max_cols} columns")
    n_cols = int(indices.max()) + 1 if len(indices) else 1
    bucket = indptr[:-1] // (max_entries - longest + 1)
    row = np.arange(n, dtype=np.int64)
    first = np.maximum.accumulate(
        np.where(np.r_[True, bucket[1:] != bucket[:-1]], row, 0))
    starts = np.flatnonzero((row - first) % max_rows == 0)
    nnz = int(indptr[-1])
    indices = indices[:nnz]
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    mark = np.zeros(n, dtype=np.int64)

    def block_of_row(starts):
        mark[:] = 0
        mark[starts] = 1
        return np.cumsum(mark) - 1

    # the one sort: the entries by (block of the first cut, column), in
    # entry order within a column.  A later block is a run of a first
    # block's entries, so its entries of one column stay side by side.
    seq = np.argsort(block_of_row(starts)[row_of] * n_cols + indices,
                     kind="stable")
    seq_row, seq_col = row_of[seq], indices[seq]
    while True:
        lab = block_of_row(starts)[seq_row]
        new = np.ones(nnz, dtype=bool)
        new[1:] = (lab[1:] != lab[:-1]) | (seq_col[1:] != seq_col[:-1])
        counts = np.bincount(lab[new], minlength=len(starts))
        wide = counts > max_cols
        if not wide.any():
            break
        ends = np.r_[starts[1:], n]
        s, e = starts[wide], ends[wide]
        mid = (indptr[s] + indptr[e]) // 2
        cut = np.clip(np.searchsorted(indptr, mid, side="right") - 1, s + 1,
                      e - 1)
        starts = np.sort(np.r_[starts, cut])
    col_ptr = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(counts, out=col_ptr[1:])
    # each block's distinct columns, in the sorted order already, and each
    # entry's place among them
    pair = np.flatnonzero(new)
    by_block = np.argsort(lab[pair], kind="stable")
    place = np.empty(len(pair), dtype=np.int64)
    place[by_block] = np.arange(len(pair)) - col_ptr[lab[pair][by_block]]
    slots = np.empty(nnz, dtype=np.int16)
    slots[seq] = place[np.cumsum(new) - 1]
    return dict(rows=np.r_[starts, n].astype(np.int32),
                col_ptr=col_ptr.astype(np.int32),
                cols=seq_col[pair][by_block].astype(np.int32), slots=slots,
                width=int(counts.max(initial=0)))


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_blocks(cap_indptr: np.ndarray,
               max_entries: int = BLOCK_ENTRIES) -> np.ndarray:
    """K1's row-block table (int32, n_blocks + 1): block b holds rows
    ``table[b]`` to ``table[b + 1]``, whose entries span at most
    ``max_entries / 4`` aligned 4-entry chunks (so at most
    ``max_entries`` entries), and at most ``max_entries / 2`` rows (two
    a thread of the kernel's block: its shared row-pointer array).

    Rows go to buckets by the chunk of their first entry, ``wc`` chunks a
    bucket, ``wc`` = the budget less the chunks a longest row can reach
    past its bucket; a bucket of more rows than that is split.  Every row
    with entries fits: its length is at most the cap."""
    if max_entries % 4 or max_entries < 4:
        raise ValueError(f"max_entries {max_entries}: a positive multiple of 4")
    max_rows = max_entries // 2
    indptr = np.asarray(cap_indptr, dtype=np.int64)
    n = len(indptr) - 1
    longest = int(np.diff(indptr).max()) if n else 0
    wc = max_entries // 4 - (longest + 2) // 4
    if wc < 1:
        raise ValueError(f"a row of {longest} entries does not fit a block "
                         f"of {max_entries}")
    bucket = indptr[:-1] // 4 // wc
    row = np.arange(n, dtype=np.int64)
    first = np.maximum.accumulate(
        np.where(np.r_[True, bucket[1:] != bucket[:-1]], row, 0))
    starts = np.flatnonzero((row - first) % max_rows == 0)
    return np.r_[starts, n].astype(np.int32)


def block_table(cap_indptr: np.ndarray, device,
                max_entries: int = BLOCK_ENTRIES) -> dict:
    """:func:`row_blocks` on ``device`` as a ``CappedCSR``'s
    ``block_rows`` and ``block_ptr``."""
    rows = row_blocks(cap_indptr, max_entries)
    return dict(block_rows=to_device(rows, device, torch.int32),
                block_ptr=to_device(cap_indptr[rows], device, torch.int32))


@dataclasses.dataclass
class CappedCSR:
    """A CSR matrix on one device, split for K1 (capped rows) + K2 (tail).

    ``indptr`` int64, ``indices``/``tail_cols`` int32, values
    (``data``, ``tail_vals``) in the working dtype, or narrower after a
    precision cast (:func:`tpu_amg_torch.precision.cast_operator`).
    K1's row-block table, built for blocks of ``BLOCK_ENTRIES``:
    ``block_rows`` (int32, n_blocks + 1, from
    :func:`row_blocks`) and ``block_ptr``, the first entry of each block
    (``indptr[block_rows]``, int32), so that a block's bounds are two
    loads of the table.  K2's tail row table (:func:`tail_row_table`):
    ``tail_row_ids`` and ``tail_ptr``, and ``tail_long``, the table
    positions of the rows longer than ``LONG_TAIL_ROW``.  The
    many-column designs' tables, built here so that a CUDA graph can
    capture any launch: K1's staged SpMM table (:func:`spmm_blocks`:
    ``spmm_rows``, ``spmm_col_ptr``, ``spmm_cols``, ``spmm_slots``,
    ``spmm_width``) and K2's piece table (:func:`k2_pieces`:
    ``piece_rows``, each tail row's first piece, ``piece_ptr``,
    ``piece_row``, ``piece_blocks``)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    shape: Tuple[int, int]
    cap: int
    block_rows: torch.Tensor
    block_ptr: torch.Tensor
    tail_row_ids: torch.Tensor
    tail_ptr: torch.Tensor
    tail_long: torch.Tensor
    spmm_rows: torch.Tensor
    spmm_col_ptr: torch.Tensor
    spmm_cols: torch.Tensor
    spmm_slots: torch.Tensor
    spmm_width: int
    piece_rows: torch.Tensor
    piece_ptr: torch.Tensor
    piece_row: torch.Tensor
    piece_blocks: torch.Tensor
    # expanded row ids of the capped part and of the tail, for the plain
    # versions
    _rows: torch.Tensor = dataclasses.field(default=None, repr=False)
    _tail_rows: torch.Tensor = dataclasses.field(default=None, repr=False)

    @staticmethod
    def from_csr(csr, device, dtype=torch.float64, cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        (ip, ix, v), (_, tc, tv) = split_capped(
            csr.indptr, csr.indices, csr.data, cap
        )
        row_ids, ptr = tail_row_table(csr.indptr, cap)
        long_rows = np.flatnonzero(np.diff(ptr) > LONG_TAIL_ROW)
        staged = spmm_blocks(ip, ix)
        pieces = k2_pieces(ptr, row_ids)
        return CappedCSR(
            indptr=to_device(ip, device, torch.int64),
            indices=to_device(ix, device, torch.int32),
            data=to_device(v, device, dtype),
            tail_cols=to_device(tc, device, torch.int32),
            tail_vals=to_device(tv, device, dtype),
            shape=tuple(csr.shape),
            cap=cap,
            **block_table(ip, device),
            tail_row_ids=to_device(row_ids, device, torch.int32),
            tail_ptr=to_device(ptr, device, torch.int32),
            tail_long=to_device(long_rows, device, torch.int32),
            spmm_rows=to_device(staged["rows"], device),
            spmm_col_ptr=to_device(staged["col_ptr"], device),
            spmm_cols=to_device(staged["cols"], device),
            spmm_slots=to_device(staged["slots"], device),
            spmm_width=staged["width"],
            piece_rows=to_device(pieces["row_piece"], device),
            piece_ptr=to_device(pieces["piece_ptr"], device),
            piece_row=to_device(pieces["piece_row"], device),
            piece_blocks=to_device(pieces["blocks"], device),
        )

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def astype(self, dtype) -> "CappedCSR":
        """The values (capped part and tail) in ``dtype``; the tables
        shared."""
        return dataclasses.replace(self, data=self.data.to(dtype),
                                   tail_vals=self.tail_vals.to(dtype))

    @property
    def nnz(self) -> int:
        return self.data.numel() + self.tail_vals.numel()

    @property
    def n_tail(self) -> int:
        return self.tail_vals.numel()

    @property
    def n_blocks(self) -> int:
        return self.block_rows.numel() - 1

    @property
    def n_tail_rows(self) -> int:
        return self.tail_row_ids.numel()

    @property
    def row_mean(self) -> float:
        """The capped rows' mean entries (K1's router reads it)."""
        return self.data.numel() / max(self.shape[0], 1)

    @property
    def n_spmm_blocks(self) -> int:
        return self.spmm_rows.numel() - 1

    @property
    def n_piece_blocks(self) -> int:
        return self.piece_blocks.shape[0] - 1

    def table_bytes(self) -> int:
        """The device bytes of the many-column designs' tables."""
        return sum(t.numel() * t.element_size() for t in (
            self.spmm_rows, self.spmm_col_ptr, self.spmm_cols,
            self.spmm_slots, self.piece_rows, self.piece_ptr,
            self.piece_row, self.piece_blocks))

    def rows(self) -> torch.Tensor:
        if self._rows is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            self._rows = torch.repeat_interleave(
                torch.arange(self.shape[0], device=self.device), counts
            )
        return self._rows

    def tail_rows(self) -> torch.Tensor:
        """The row of every tail entry (int64), from the tail row table."""
        if self._tail_rows is None:
            self._tail_rows = torch.repeat_interleave(
                self.tail_row_ids.long(),
                (self.tail_ptr[1:] - self.tail_ptr[:-1]).long())
        return self._tail_rows

    def to_csr(self):
        """The matrix on the host, capped part and tail together."""
        from tpu_amg_torch.sparse.csr import CSR

        def host(*ts):
            return [t.cpu().numpy() for t in ts]

        rows, cols, vals = host(self.rows(), self.indices, self.data)
        t_rows, t_cols, t_vals = host(self.tail_rows(), self.tail_cols,
                                      self.tail_vals)
        return CSR.from_coo(
            np.concatenate([rows, t_rows]), np.concatenate([cols, t_cols]),
            np.concatenate([vals, t_vals]), self.shape,
        )


def k1_bytes(mat: CappedCSR, k: int = 1, dtype: torch.dtype = None) -> int:
    """The bytes K1 must move at k columns, each once: capped values and
    indices, int64 row pointers, X (m, k) and Y (n, k) of ``dtype``
    (the values' dtype when None)."""
    isz = mat.data.element_size()
    xsz = isz if dtype is None else torch.empty((), dtype=dtype).element_size()
    n, m = mat.shape
    return mat.data.numel() * (isz + 4) + 8 * (n + 1) + (m + n) * k * xsz


def check_x(mat, x: torch.Tensor) -> int:
    """Validate x for a device matrix ``mat`` (``CappedCSR`` or ``DIA``:
    ``device``, ``dtype`` and ``shape``; the values' and x's dtypes a
    pair of ``PAIRS``); returns k (1 for a vector)."""
    if x.device != mat.device:
        raise ValueError(f"x on {x.device}, matrix on {mat.device}")
    pair_suffix(mat.dtype, x.dtype)
    if x.dim() not in (1, 2) or x.shape[0] != mat.shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} for A {mat.shape}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    k = 1 if x.dim() == 1 else x.shape[1]
    if not 1 <= k <= MAX_COLUMNS:
        raise ValueError(f"k = {k} columns; the kernels take 1..{MAX_COLUMNS}")
    return k


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = kernel_lib().kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _kernel(name: str, mat: CappedCSR, x: torch.Tensor):
    """The C entry point ``name`` for the values' and x's dtypes; raises
    off the card."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {x.device}")
    return getattr(kernel_lib(), f"{name}_{pair_suffix(mat.dtype, x.dtype)}")


def check_row_block_kernel(mat: CappedCSR, k: int = 1) -> None:
    """The checks the row-block kernels' 32-bit offsets and the SpMM's
    16-byte copies need."""
    if max(mat.data.numel(), max(mat.shape) * k) > _INT32_MAX:
        raise ValueError(f"A {mat.shape} with {mat.data.numel()} entries "
                         f"at k = {k} passes 32-bit offsets")
    if mat.indices.data_ptr() % 16 or mat.data.data_ptr() % 16:
        raise ValueError("indices and values must be 16-byte aligned")


def plain_csr_spmv_capped(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (same contract, any device): the
    values widened to x's dtype first."""
    x2 = x.reshape(mat.shape[1], -1)
    y = torch.zeros(mat.shape[0], x2.shape[1], dtype=x.dtype, device=x.device)
    y.index_add_(0, mat.rows(),
                 mat.data.to(x.dtype)[:, None] * x2[mat.indices.long()])
    return y.reshape((mat.shape[0],) + tuple(x.shape[1:]))


def plain_coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor) -> None:
    """Plain PyTorch version of K2: y += tail · x, in place, the values
    widened to x's dtype first."""
    x2 = x.reshape(mat.shape[1], -1)
    y2 = y.view(mat.shape[0], -1)
    y2.index_add_(0, mat.tail_rows(), mat.tail_vals.to(x.dtype)[:, None]
                  * x2[mat.tail_cols.long()])


def launch_csr_spmv_capped(fn, mat: CappedCSR, x: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Launch ``fn``, a ``csr_spmv_capped_*`` entry point of a kernel
    library, on CUDA tensors; counts nothing."""
    check_row_block_kernel(mat, k)
    y = torch.empty((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_blocks, k, mat.block_rows.data_ptr(),
            mat.block_ptr.data_ptr(), mat.indptr.data_ptr(),
            mat.indices.data_ptr(), mat.data.data_ptr(), x.data_ptr(),
            y.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "csr_spmv_capped")
    return y


def launch_first_spmm(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """K1's first designs at any k, uncounted: the k = 1 kernel, or the
    first SpMM design (csr_rowblock.cuh ``spmm_kernel``), the reference on
    the card, which the wrapper routes where :func:`k1_design` says
    "first"."""
    k = check_x(mat, x)
    return launch_csr_spmv_capped(_kernel("csr_spmv_capped", mat, x), mat, x,
                                  k)


def launch_staged_spmm(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """K1's staged SpMM (csr_spmm.cuh) at any k, uncounted: the X rows
    staged in shared memory where they are at most ``SPMM_STAGE_ROW``
    bytes, else read through L1 (the gather mode).  The wrapper routes
    it where :func:`k1_design` says "staged" or "gather"."""
    k = check_x(mat, x)
    fn = _kernel("csr_spmm_staged", mat, x)
    check_row_block_kernel(mat, k)
    y = torch.empty((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if mat.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_spmm_blocks, k, mat.spmm_width,
            int(k * x.element_size() <= SPMM_STAGE_ROW),
            mat.spmm_rows.data_ptr(),
            mat.spmm_col_ptr.data_ptr(), mat.spmm_cols.data_ptr(),
            mat.spmm_slots.data_ptr(), mat.indices.data_ptr(),
            mat.indptr.data_ptr(),
            mat.data.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "csr_spmv_capped (staged SpMM)")
    return y


def csr_spmv_capped(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """K1: Y = A_cap X (the first ``mat.cap`` entries of every row), by
    :func:`k1_design`."""
    global csr_spmv_launches
    k = check_x(mat, x)
    if x.device.type == "cpu":
        return plain_csr_spmv_capped(mat, x)
    design = k1_design(k, x.element_size(), mat.row_mean)
    if design in ("staged", "gather"):
        y = launch_staged_spmm(mat, x)
    else:
        y = launch_csr_spmv_capped(_kernel("csr_spmv_capped", mat, x), mat,
                                   x, k)
    if mat.shape[0]:
        csr_spmv_launches += 1
        csr_spmv_launches_by_shape[(*mat.shape, k)] += 1
        csr_spmv_launches_by_dtype[(mat.dtype, x.dtype)] += 1
        csr_spmv_launches_by_design[design] += 1
    return y


def launch_coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor,
                     k: int, lanes: int) -> None:
    """Launch K2 on CUDA tensors (x checked, a tail present) with teams
    of ``lanes`` lanes a tail row: 8, 16 or 32, and no fewer than the
    group width (the power of two at or above k, at most 32).  Counts
    nothing."""
    fn = _kernel("coo_patch", mat, x)
    if max(mat.shape) * k > _INT32_MAX:
        raise ValueError(f"A {mat.shape} at k = {k} passes 32-bit offsets")
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_tail_rows, mat.tail_long.numel(), k, lanes,
            mat.tail_row_ids.data_ptr(), mat.tail_ptr.data_ptr(),
            mat.tail_long.data_ptr(), mat.tail_cols.data_ptr(),
            mat.tail_vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "coo_patch")


def launch_coo_pieces(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor,
                      k: int) -> None:
    """Launch K2's piece design (csrc/spmv.cu ``pieces``) on CUDA tensors
    (x checked, a tail present) at any k; counts nothing."""
    fn = _kernel("coo_patch_pieces", mat, x)
    if max(mat.shape) * k > _INT32_MAX:
        raise ValueError(f"A {mat.shape} at k = {k} passes 32-bit offsets")
    with torch.cuda.device(x.device):
        code = fn(
            mat.n_piece_blocks, k, mat.piece_blocks.data_ptr(),
            mat.piece_rows.data_ptr(), mat.piece_ptr.data_ptr(),
            mat.piece_row.data_ptr(), mat.tail_row_ids.data_ptr(),
            mat.tail_cols.data_ptr(),
            mat.tail_vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "coo_patch (pieces)")


def coo_patch(mat: CappedCSR, x: torch.Tensor, y: torch.Tensor) -> None:
    """K2: y[r] += Σ v · x[c] over the tail entries of each row r, in
    place: at k = 1 a team of :func:`k2_lanes` lanes a tail row, at k > 1
    the pieces (:func:`launch_coo_pieces`)."""
    global coo_patch_launches
    k = check_x(mat, x)
    if (y.shape != (mat.shape[0],) + tuple(x.shape[1:])
            or y.device != x.device or y.dtype != x.dtype
            or not y.is_contiguous()):
        raise ValueError(f"y ({tuple(y.shape)}, {y.dtype}, {y.device}) does "
                         f"not match A {mat.shape} and x")
    if mat.n_tail == 0:
        return
    if x.device.type == "cpu":
        plain_coo_patch(mat, x, y)
        return
    if k > 1:
        launch_coo_pieces(mat, x, y, k)
    else:
        launch_coo_patch(mat, x, y, k, k2_lanes(mat.n_tail_rows, k,
                                                sm_count(x.device.index)))
    coo_patch_launches += 1
    coo_patch_launches_by_shape[(*mat.shape, k)] += 1
    coo_patch_launches_by_dtype[(mat.dtype, x.dtype)] += 1


def spmv(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A x (or Y = A X): K1, then K2 on the same stream."""
    y = csr_spmv_capped(mat, x)
    coo_patch(mat, x, y)
    return y


def plain_spmv(mat: CappedCSR, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv`, on any device."""
    y = plain_csr_spmv_capped(mat, x)
    plain_coo_patch(mat, x, y)
    return y
