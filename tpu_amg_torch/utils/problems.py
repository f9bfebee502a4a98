"""Model-problem generators.

Structured Poisson in 1-D, 2-D and 3-D, rotated anisotropic diffusion
(the CLI's default problem), the pseudo-unstructured 2-D and 3-D
FEM-graph Laplacians of the reference's MFEM-loaded systems, and the
1-D geometric transfers of the refinement study; the same matrices as
the JAX package's ``tpu_amg/utils/problems.py`` from the same seeds.
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


def anisotropic_diffusion_2d(
    nx: int,
    ny: int = None,
    epsilon: float = 1e-3,
    theta: float = 0.0,
    coefficient: str = "constant",
    seed: int = 0,
) -> CSR:
    """Rotated anisotropic diffusion −∇·(K∇u) on a structured grid, FEM
    (bilinear quad) stencil.

    K = Rᵀ diag(1, ε) R with rotation θ; ``coefficient`` modulates the
    scalar magnitude over space, mimicking the reference's coefficient
    datasets (examples/amg/main.rs:123-140, 479-500): "constant",
    "random" (log-uniform per cell), "layers" (horizontal bands),
    "checkerboard".
    """
    ny = ny or nx
    rng = np.random.default_rng(seed)
    c, s = np.cos(theta), np.sin(theta)
    # diffusion tensor entries
    kxx = c * c + epsilon * s * s
    kyy = s * s + epsilon * c * c
    kxy = (1.0 - epsilon) * c * s

    # per-cell scalar coefficient on an (nx+1)×(ny+1) cell grid
    cx, cy = nx + 1, ny + 1
    if coefficient == "constant":
        coef = np.ones((cx, cy))
    elif coefficient == "random":
        coef = 10.0 ** rng.uniform(-3, 3, size=(cx, cy))
    elif coefficient == "layers":
        bands = (np.arange(cx) // max(cx // 8, 1)) % 2
        coef = np.where(bands, 1e3, 1.0)[:, None] * np.ones((1, cy))
    elif coefficient == "checkerboard":
        ix, iy = np.meshgrid(np.arange(cx), np.arange(cy), indexing="ij")
        coef = np.where((ix // 4 + iy // 4) % 2 == 0, 1.0, 1e3)
    else:
        raise ValueError(f"unknown coefficient field {coefficient!r}")

    # Q1 FEM element stiffness for anisotropic K on a unit square cell
    # (exact integration of bilinear basis gradients)
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    nodes_local = [(0, 0), (1, 0), (1, 1), (0, 1)]
    ke = np.zeros((4, 4))
    K = np.array([[kxx, kxy], [kxy, kyy]])
    for gx in gp:
        for gy in gp:
            # shape function gradients on [-1,1]^2 mapped to unit cell
            dn = []
            for (a, b) in nodes_local:
                sa, sb = 2 * a - 1, 2 * b - 1
                dn.append(
                    [
                        0.25 * sa * (1 + sb * gy) * 2.0,
                        0.25 * sb * (1 + sa * gx) * 2.0,
                    ]
                )
            dn = np.array(dn)  # (4, 2)
            ke += 0.25 * dn @ K @ dn.T
    # assemble over cells; interior dofs only (Dirichlet boundary removed)
    node_idx = -np.ones((cx + 1, cy + 1), dtype=np.int64)
    node_idx[1:-1, 1:-1] = np.arange(nx * ny).reshape(nx, ny)
    rows, cols, vals = [], [], []
    cell_x, cell_y = np.meshgrid(np.arange(cx), np.arange(cy), indexing="ij")
    cell_x, cell_y = cell_x.ravel(), cell_y.ravel()
    cell_coef = coef[cell_x, cell_y]
    corner = [
        node_idx[cell_x, cell_y],
        node_idx[cell_x + 1, cell_y],
        node_idx[cell_x + 1, cell_y + 1],
        node_idx[cell_x, cell_y + 1],
    ]
    for a in range(4):
        for b in range(4):
            ia, ib = corner[a], corner[b]
            ok = (ia >= 0) & (ib >= 0)
            rows.append(ia[ok])
            cols.append(ib[ok])
            vals.append(cell_coef[ok] * ke[a, b])
    return CSR.from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (nx * ny, nx * ny),
    )


def unstructured_poisson_2d(
    side: int, seed: int = 0, jitter: float = 0.35, rcm: bool = True,
    diag_shift: float = 1e-8,
) -> CSR:
    """Pseudo-unstructured 2-D FEM-graph Laplacian: jittered side² grid
    points, randomly renumbered, Delaunay-triangulated, then
    RCM-reordered — the matrix class the reference's MFEM loader serves
    (reference utils.rs:269-350) and the hard case for TPU SpMV."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side * side
    gx, gy = np.meshgrid(np.arange(side, dtype=np.float64),
                         np.arange(side, dtype=np.float64))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    tri = Delaunay(pts[rng.permutation(n_pts)])
    e = np.concatenate([tri.simplices[:, [0, 1]],
                        tri.simplices[:, [1, 2]],
                        tri.simplices[:, [2, 0]]])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix((np.ones(len(i)), (i, j)),
                       shape=(n_pts, n_pts)).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (
        a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + diag_shift)
    ).tocsr()
    if rcm:
        p = reverse_cuthill_mckee(a, symmetric_mode=True)
        a = a[p][:, p].tocsr()
    a.sort_indices()
    return CSR.from_scipy(a)


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


def geometric_interpolation_1d(n_coarse: int) -> CSR:
    """Linear-interpolation P: (2·n_coarse+1) × n_coarse
    (reference simple_geometric.rs:62-75): column j has stencil
    ½[1 2 1] at rows 2j, 2j+1, 2j+2."""
    rows = np.concatenate(
        [2 * np.arange(n_coarse) + k for k in range(3)]
    )
    cols = np.tile(np.arange(n_coarse), 3)
    vals = np.concatenate(
        [
            np.full(n_coarse, 0.5),
            np.full(n_coarse, 1.0),
            np.full(n_coarse, 0.5),
        ]
    )
    return CSR.from_coo(rows, cols, vals, (2 * n_coarse + 1, n_coarse))


def geometric_restriction_1d(n_coarse: int) -> CSR:
    """Full-weighting R = ¼[1 2 1] (reference simple_geometric.rs:80-93);
    R = ½Pᵀ, satisfying the variational property up to a scalar."""
    import dataclasses

    pt = geometric_interpolation_1d(n_coarse).transpose()
    return dataclasses.replace(pt, data=pt.data * 0.5)
