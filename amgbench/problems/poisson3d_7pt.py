"""The 3-D 7-point Laplacian on an n³ interior grid, Dirichlet, h = 1:
6 on the diagonal, −1 to each grid neighbour (hypre ``ij -laplacian``).

A frozen copy of ``tpu_amg_torch.utils.problems.poisson3d``: the same
entries in the same CSR order (``amgbench/tests/test_amgbench_inputs.py``).
"""

import numpy as np
import scipy.sparse as sps


def make(config: dict) -> dict:
    n = int(config["n"])
    idx = np.arange(n ** 3).reshape(n, n, n)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n ** 3, 6.0)]
    for axis in range(3):
        lo = idx.take(np.arange(n - 1), axis=axis).ravel()
        hi = idx.take(np.arange(1, n), axis=axis).ravel()
        rows.extend([lo, hi])
        cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    a = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n ** 3, n ** 3)).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return dict(indptr=a.indptr.astype(np.int64),
                indices=a.indices.astype(np.int32),
                data=a.data.astype(np.float64), grid=(n, n, n))
