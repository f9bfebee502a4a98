"""The table of peaks and the bytes of a sparse matrix-vector product.

Peaks of one NVIDIA H100 SXM (the data sheet): 3,350 GB/s of HBM, a
50 MB L2.  The L2's read rate is not on the data sheet: the benchmark
measures it in the same run (:func:`amgbench.timing.l2_read_gbps`).
"""

from __future__ import annotations

HBM_GBPS = 3350.0
L2_BYTES = 50 * 2 ** 20


def spmv_bytes(nnz: int, n: int, value_bytes: int, vector_bytes: int) -> int:
    """The least bytes y = A x moves: each value once, x read once and y
    written once.  Index bytes are not counted, so every storage format
    (DIA, capped CSR) is held to the same work."""
    return nnz * value_bytes + n * 2 * vector_bytes


def bound(nbytes: int, l2_gbps) -> tuple:
    """(GB/s, name) of the bound a working set of ``nbytes`` meets:
    HBM where it passes the L2, else the L2 read rate measured in the
    run (``l2_gbps``, a callable, asked only then)."""
    if nbytes > L2_BYTES:
        return HBM_GBPS, "HBM data sheet"
    return l2_gbps(), "L2 read rate measured in this run"


def share_pct(nbytes: int, gbps: float, measured_ms: float) -> float:
    """The least time over the measured time, in percent."""
    return 100.0 * (nbytes / gbps / 1e6) / measured_ms
