"""Model-problem generators.

Structured Poisson in 1-D, 2-D and 3-D, and the pseudo-unstructured
3-D FEM-graph Laplacian of the reference's MFEM-loaded systems.
"""

from __future__ import annotations

import numpy as np

from tpu_amg_torch.sparse.csr import CSR


def poisson1d(n_elements: int) -> CSR:
    """Interior-point FD discretization of -u'' on [0,1], homogeneous
    Dirichlet (reference simple_geometric.rs:96-113): n_elements-1 dofs,
    tridiag(-1, 2, -1)/h²."""
    h = 1.0 / n_elements
    n = n_elements - 1
    main = np.full(n, 2.0 / h**2)
    off = np.full(n - 1, -1.0 / h**2)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    return CSR.from_coo(rows, cols, vals, (n, n))


def _grid_idx(shape):
    return np.arange(int(np.prod(shape))).reshape(shape)


def poisson2d(nx: int, ny: int = None) -> CSR:
    """5-point Laplacian on an nx×ny interior grid, Dirichlet, h=1."""
    ny = ny or nx
    idx = _grid_idx((nx, ny))
    rows, cols, vals = [], [], []
    n = nx * ny
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(np.full(n, 4.0))
    for axis, count in ((0, nx), (1, ny)):
        lo = idx.take(np.arange(count - 1), axis=axis).ravel()
        hi = idx.take(np.arange(1, count), axis=axis).ravel()
        rows.extend([lo, hi])
        cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )


def poisson3d(nx: int, ny: int = None, nz: int = None) -> CSR:
    """7-point Laplacian on an interior grid, Dirichlet, h=1."""
    ny = ny or nx
    nz = nz or nx
    idx = _grid_idx((nx, ny, nz))
    n = nx * ny * nz
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for axis, count in ((0, nx), (1, ny), (2, nz)):
        lo = idx.take(np.arange(count - 1), axis=axis).ravel()
        hi = idx.take(np.arange(1, count), axis=axis).ravel()
        rows.extend([lo, hi])
        cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )


def unstructured_fem_system(side: int, seed: int = 0) -> CSR:
    """Pseudo-unstructured 2-D FEM Laplacian: side² jittered grid points,
    randomly renumbered, Delaunay-triangulated, then RCM-reordered.

    The matrix of the SpMV stage ablations (``bench.py:53-81``, the
    matrix of ``tools/well2proto.py`` and ``tools/wellablate*.py``): ~7
    entries a row, at most ~20; side 1024 gives 1,048,576 rows and
    7,339,948 entries."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side * side
    gx, gy = np.meshgrid(np.arange(side, dtype=np.float64),
                         np.arange(side, dtype=np.float64))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    pts += rng.uniform(-0.35, 0.35, pts.shape)
    tri = Delaunay(pts[rng.permutation(n_pts)])
    e = np.concatenate([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]],
                        tri.simplices[:, [2, 0]]])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix((np.ones(len(i)), (i, j)),
                       shape=(n_pts, n_pts)).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + 1e-8)).tocsr()
    p = reverse_cuthill_mckee(a, symmetric_mode=True)
    ap = a[p][:, p].tocsr()
    ap.sort_indices()
    return CSR.from_scipy(ap)


def unstructured_poisson_3d(
    side: int, seed: int = 0, jitter: float = 0.3, rcm: bool = True,
    return_coords: bool = False,
):
    """Pseudo-unstructured 3-D FEM-graph Laplacian: jittered side³ grid
    points, randomly renumbered, Delaunay-tetrahedralized, graph
    Laplacian over tet edges, then RCM-reordered.

    This is BASELINE.json configs[2] ("~1M-dof 3-D unstructured
    Poisson") — the matrix class the reference's MFEM loader serves
    (reference utils.rs:269-350) with genuinely 3-D band statistics
    (RCM bandwidth ~ n^(2/3), ~15 nnz/row vs ~7 in 2-D).
    """
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side**3
    gx, gy, gz = np.meshgrid(*(np.arange(side, dtype=np.float64),) * 3)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    perm = rng.permutation(n_pts)
    tri = Delaunay(pts[perm])
    s = tri.simplices
    e = np.concatenate([
        s[:, [0, 1]], s[:, [0, 2]], s[:, [0, 3]],
        s[:, [1, 2]], s[:, [1, 3]], s[:, [2, 3]],
    ])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix(
        (np.ones(len(i)), (i, j)), shape=(n_pts, n_pts)
    ).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + 1e-8)).tocsr()
    coords = pts[perm]
    if rcm:
        p = reverse_cuthill_mckee(a, symmetric_mode=True)
        a = a[p][:, p].tocsr()
        coords = coords[p]
    a.sort_indices()
    csr = CSR.from_scipy(a)
    if return_coords:
        return csr, coords
    return csr
