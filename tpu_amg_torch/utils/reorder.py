"""Bandwidth-reducing reordering (reverse Cuthill-McKee).

RCM renumbering turns general FEM orderings into banded ones: with a
small enough band the matrix takes the DIA route (K3,
:mod:`tpu_amg_torch.ops.dia`); otherwise it still tightens the gathers'
locality in K1.  One-time host setup work on scipy, as in the JAX
package's ``tpu_amg/utils/reorder.py``.
"""

from __future__ import annotations

import numpy as np

from tpu_amg_torch.sparse.csr import CSR


def rcm_permutation(a: CSR) -> np.ndarray:
    """perm such that A[perm][:, perm] has (near-)minimal bandwidth."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee(a.to_scipy(), symmetric_mode=True),
        dtype=np.int64,
    )


def permute_symmetric(a: CSR, perm: np.ndarray) -> CSR:
    """B = A[perm][:, perm] (relabel rows and columns by perm)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows, cols, vals = a.coo()
    return CSR.from_coo(
        inv[rows], inv[cols], vals, a.shape, a.block_size
    )


def bandwidth(a: CSR) -> int:
    """max |i - j| over stored entries."""
    rows, cols, _ = a.coo()
    if len(rows) == 0:
        return 0
    return int(np.abs(rows - cols).max())


def rcm_reorder(a: CSR):
    """Returns (permuted matrix, perm, inverse perm)."""
    perm = rcm_permutation(a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return permute_symmetric(a, perm), perm, inv


def block_rcm_permutation(a: CSR) -> np.ndarray:
    """RCM permutation that keeps ``block_size`` dense blocks contiguous
    (vector problems: DOF ordering x1,y1,z1,... must survive — reference
    core.rs:22-36)."""
    b = a.block_size
    if b <= 1:
        return rcm_permutation(a)
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows, cols, _ = a.coo()
    nb = a.nrows // b
    g = sps.coo_matrix(
        (np.ones(len(rows)), (rows // b, cols // b)), shape=(nb, nb)
    ).tocsr()
    pb = np.asarray(
        reverse_cuthill_mckee(g, symmetric_mode=True), dtype=np.int64
    )
    return (pb[:, None] * b + np.arange(b)[None, :]).reshape(-1)


def permute_rows(a: CSR, perm: np.ndarray) -> CSR:
    """B = A[perm, :] (new row i is old row perm[i])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows, cols, vals = a.coo()
    return CSR.from_coo(inv[rows], cols, vals, a.shape, a.block_size)


def permute_cols(a: CSR, perm: np.ndarray) -> CSR:
    """B = A[:, perm] (new col j is old col perm[j])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows, cols, vals = a.coo()
    return CSR.from_coo(rows, inv[cols], vals, a.shape, a.block_size)
