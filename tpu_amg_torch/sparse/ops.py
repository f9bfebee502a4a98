"""Host-side sparse algebra: SpGEMM, Galerkin RAP, add.

The reference gets SpGEMM (``A * P``), transpose and sparse addition
from faer (reference interpolation/mod.rs:720, 824-828, 945).  These are
setup-time operations, run once per hierarchy build and amortized over
many solves, so they live on the host.  SpGEMM is the native two-pass
C++ kernel (:mod:`tpu_amg_torch.ops.native`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpu_amg_torch.ops import native
from tpu_amg_torch.sparse.csr import CSR


def from_coo(rows, cols, vals, shape: Tuple[int, int], block_size: int = 1) -> CSR:
    return CSR.from_coo(rows, cols, vals, shape, block_size)


def spgemm(a: CSR, b: CSR) -> CSR:
    """C = A @ B (sparse-sparse). Equivalent of faer ``operator*``."""
    if a.ncols != b.nrows:
        raise ValueError(f"spgemm shape mismatch {a.shape} @ {b.shape}")
    return native.spgemm(a, b)


def sp_add(a: CSR, b: CSR, alpha: float = 1.0, beta: float = 1.0) -> CSR:
    """C = alpha*A + beta*B (faer ``add_assign`` analog)."""
    if a.shape != b.shape:
        raise ValueError(f"sp_add shape mismatch {a.shape} vs {b.shape}")
    rows_a, cols_a, vals_a = a.coo()
    rows_b, cols_b, vals_b = b.coo()
    return CSR.from_coo(
        np.concatenate([rows_a, rows_b]),
        np.concatenate([cols_a, cols_b]),
        np.concatenate([alpha * vals_a, beta * vals_b]),
        a.shape,
        a.block_size,
    )


def rap(a: CSR, p: CSR, r: CSR = None) -> CSR:
    """Galerkin triple product A_c = R (A P), with R = Pᵀ by default.

    Reference interpolation/mod.rs:824-828 (SA).
    """
    if r is None:
        r = p.transpose()
    return spgemm(r, spgemm(a, p))
