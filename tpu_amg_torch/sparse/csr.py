"""CSR sparse matrix container (host / setup side).

The reference builds everything on faer's ``SparseRowMat<usize, f64>``
(reference core.rs:13-17) and constructs matrices from triplets with
duplicate summing (``try_new_from_triplets``, used throughout reference
interpolation/mod.rs and utils.rs).  This module provides the equivalent:
a small immutable CSR container backed by numpy.  Setup runs on the host
(partitioning, SpGEMM, interpolation assembly: one-time work amortized
over many solves); the solve converts each operator to a device
:class:`tpu_amg_torch.ops.spmv.CappedCSR`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _as_np(a, dtype=None):
    arr = np.asarray(a)
    if dtype is not None:
        arr = arr.astype(dtype, copy=False)
    return arr


@dataclasses.dataclass(frozen=True)
class CSR:
    """Immutable CSR matrix.

    Attributes:
      data:    (nnz,) float64 values.
      indices: (nnz,) int32 column indices (sorted within each row).
      indptr:  (nrows+1,) int64 row pointers.
      shape:   (nrows, ncols).
      block_size: indivisible dense block size for coarsening/smoothing
        semantics (DOF ordering x1,y1,z1,x2,... — reference core.rs:22-36).
        Metadata only; storage stays scalar CSR like the reference.
    """

    data: np.ndarray
    indices: np.ndarray
    indptr: np.ndarray
    shape: Tuple[int, int]
    block_size: int = 1

    def __post_init__(self):
        nrows, _ = self.shape
        if len(self.indptr) != nrows + 1:
            raise ValueError(
                f"indptr length {len(self.indptr)} != nrows+1 ({nrows + 1})"
            )
        if self.block_size > 1 and nrows % self.block_size != 0:
            # reference core.rs:103-110 panics on indivisible block size
            raise ValueError(
                f"nrows {nrows} not divisible by block_size {self.block_size}"
            )

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_coo(
        rows, cols, vals, shape: Tuple[int, int], block_size: int = 1
    ) -> "CSR":
        """Build CSR from COO triplets, summing duplicates.

        Equivalent of faer ``try_new_from_triplets`` (used throughout the
        reference, e.g. interpolation/mod.rs:807, 711-713).
        """
        rows = _as_np(rows, np.int64)
        cols = _as_np(cols, np.int64)
        vals = _as_np(vals, np.float64)
        nrows, ncols = shape
        if rows.size:
            if rows.min() < 0 or rows.max() >= nrows:
                raise ValueError("row index out of bounds")
            if cols.min() < 0 or cols.max() >= ncols:
                raise ValueError("col index out of bounds")
        # sort by (row, col), then segment-sum duplicates
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if rows.size:
            # unique (row, col) pairs
            key = rows * ncols + cols
            uniq_mask = np.empty(len(key), dtype=bool)
            uniq_mask[0] = True
            np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
            starts = np.flatnonzero(uniq_mask)
            vals = np.add.reduceat(vals, starts)
            rows = rows[starts]
            cols = cols[starts]
        counts = np.bincount(rows, minlength=nrows)
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(
            data=vals,
            indices=cols.astype(np.int32),
            indptr=indptr,
            shape=shape,
            block_size=block_size,
        )

    @staticmethod
    def from_dense(mat, block_size: int = 1, tol: float = 0.0) -> "CSR":
        mat = _as_np(mat, np.float64)
        rows, cols = np.nonzero(np.abs(mat) > tol)
        return CSR.from_coo(rows, cols, mat[rows, cols], mat.shape, block_size)

    @staticmethod
    def from_scipy(sp, block_size: int = 1) -> "CSR":
        sp = sp.tocsr()
        sp.sum_duplicates()
        sp.sort_indices()
        return CSR(
            data=_as_np(sp.data, np.float64),
            indices=_as_np(sp.indices, np.int32),
            indptr=_as_np(sp.indptr, np.int64),
            shape=tuple(sp.shape),
            block_size=block_size,
        )

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(len(self.data))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def with_block_size(self, block_size: int) -> "CSR":
        """Reference core.rs:98-110 ``set_block_size``."""
        return dataclasses.replace(self, block_size=block_size)

    # ------------------------------------------------------------------
    # dense / vector ops (host oracle paths)
    # ------------------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        np.add.at(out, (rows, self.indices), self.data)
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference SpMV."""
        x = _as_np(x)
        out_shape = (self.nrows,) + x.shape[1:]
        out = np.zeros(out_shape, dtype=np.result_type(self.data, x))
        np.add.at(
            out,
            np.repeat(np.arange(self.nrows), self.row_nnz()),
            self.data.reshape((-1,) + (1,) * (x.ndim - 1)) * x[self.indices],
        )
        return out

    def diagonal(self) -> np.ndarray:
        if not self.is_square:
            raise ValueError("diagonal of non-square matrix")
        diag = np.zeros(self.nrows)
        for_rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        mask = for_rows == self.indices
        diag[for_rows[mask]] = self.data[mask]
        return diag

    def row_sums(self) -> np.ndarray:
        out = np.zeros(self.nrows)
        np.add.at(out, np.repeat(np.arange(self.nrows), self.row_nnz()), self.data)
        return out

    def abs_row_sums(self) -> np.ndarray:
        out = np.zeros(self.nrows)
        np.add.at(
            out, np.repeat(np.arange(self.nrows), self.row_nnz()), np.abs(self.data)
        )
        return out

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals) triplet view."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), self.row_nnz())
        return rows, self.indices.astype(np.int64), self.data

    # ------------------------------------------------------------------
    # structural ops
    # ------------------------------------------------------------------
    def transpose(self) -> "CSR":
        rows, cols, vals = self.coo()
        return CSR.from_coo(
            cols, rows, vals, (self.shape[1], self.shape[0]), self.block_size
        )

    def eliminate_zeros(self, tol: float = 0.0) -> "CSR":
        rows, cols, vals = self.coo()
        keep = np.abs(vals) > tol
        return CSR.from_coo(
            rows[keep], cols[keep], vals[keep], self.shape, self.block_size
        )

    def extract(self, row_idx, col_idx) -> np.ndarray:
        """Dense submatrix A[np.ix_(row_idx, col_idx)] (for block smoothers)."""
        row_idx = _as_np(row_idx, np.int64)
        col_idx = _as_np(col_idx, np.int64)
        col_map = -np.ones(self.ncols, dtype=np.int64)
        col_map[col_idx] = np.arange(len(col_idx))
        out = np.zeros((len(row_idx), len(col_idx)))
        for oi, i in enumerate(row_idx):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            local = col_map[self.indices[lo:hi]]
            sel = local >= 0
            out[oi, local[sel]] = self.data[lo:hi][sel]
        return out

    def __repr__(self):
        return (
            f"CSR(shape={self.shape}, nnz={self.nnz}, "
            f"block_size={self.block_size})"
        )
