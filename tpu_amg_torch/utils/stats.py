"""Matrix statistics and aligned text reporting.

Reference ``matrix_stats`` + ``write_matrix_stats_table``
(utils.rs:77-241) and the hierarchy/partition tables
(hierarchy.rs:72-170).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from tpu_amg_torch.sparse.csr import CSR


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    rows: int
    cols: int
    nnz: int
    sparsity: float
    min_per_row: int
    max_per_row: int
    avg_per_row: float
    min_val: float
    max_val: float
    avg_val: float
    min_rowsum: float
    max_rowsum: float
    avg_rowsum: float


def matrix_stats(a: CSR) -> MatrixStats:
    per_row = a.row_nnz() if a.nrows else np.zeros(1, dtype=np.int64)
    rowsums = a.row_sums() if a.nrows else np.zeros(1)
    vals = a.data if a.nnz else np.zeros(1)
    return MatrixStats(
        rows=a.nrows,
        cols=a.ncols,
        nnz=a.nnz,
        sparsity=1.0 - a.nnz / max(a.nrows * a.ncols, 1),
        min_per_row=int(per_row.min()),
        max_per_row=int(per_row.max()),
        avg_per_row=float(per_row.mean()),
        min_val=float(vals.min()),
        max_val=float(vals.max()),
        avg_val=float(vals.mean()),
        min_rowsum=float(rowsums.min()),
        max_rowsum=float(rowsums.max()),
        avg_rowsum=float(rowsums.mean()),
    )


def mats_are_equal(
    a: CSR, b: CSR, rtol: float = 1e-12, atol: float = 1e-12
) -> bool:
    """Elementwise sparse-matrix comparison (reference utils.rs:32-58)."""
    if a.shape != b.shape:
        return False
    rows_a, cols_a, vals_a = a.eliminate_zeros().coo()
    rows_b, cols_b, vals_b = b.eliminate_zeros().coo()
    if len(vals_a) != len(vals_b):
        return False
    if not (np.array_equal(rows_a, rows_b) and np.array_equal(cols_a, cols_b)):
        return False
    return bool(np.allclose(vals_a, vals_b, rtol=rtol, atol=atol))


def format_stats_table(stats_list: List[MatrixStats], titles=None) -> str:
    """Aligned per-level stats table (reference utils.rs:176-241)."""
    titles = titles or [f"level {i}" for i in range(len(stats_list))]
    headers = [
        "level", "rows", "nnz", "sparsity", "nnz/row(min/avg/max)",
        "val(min/avg/max)", "rowsum(avg)",
    ]
    rows = []
    for t, s in zip(titles, stats_list):
        rows.append(
            [
                t,
                str(s.rows),
                str(s.nnz),
                f"{s.sparsity:.4f}",
                f"{s.min_per_row}/{s.avg_per_row:.1f}/{s.max_per_row}",
                f"{s.min_val:.2e}/{s.avg_val:.2e}/{s.max_val:.2e}",
                f"{s.avg_rowsum:.2e}",
            ]
        )
    widths = [
        max(len(headers[i]), *(len(r[i]) for r in rows)) for i in range(len(headers))
    ]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)
