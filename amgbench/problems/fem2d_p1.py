"""MFEM example 1 (``examples/ex1p.cpp``) in 2-D: −Δu = f on the unit
square, u = 0 on the boundary, order-1 (P1) elements, on MFEM's inline
triangle mesh (``nx`` × ``ny`` squares of ``sx`` × ``sy``, each cut into
two triangles along its south-west to north-east diagonal) refined as
ex1p refines it: uniformly, serially while the mesh stays at or under
``max_serial_elements`` elements, then ``par_ref_levels`` more times.

A uniform refinement cuts each triangle into four similar ones, so the
refined mesh is the inline mesh of 2^levels times as many squares a side;
that mesh is built directly.  The element matrices are assembled as
MFEM's ``BilinearForm::Assemble`` does with its default ``skip_zeros``
(an entry that is zero in an element matrix is not added), and the
boundary dofs are removed (ex1p keeps them as decoupled identity rows).
Vertices are numbered row by row.
"""

import math

import numpy as np
import scipy.sparse as sps


def refinements(nx: int, ny: int, max_serial_elements: int,
                par_ref_levels: int) -> int:
    """ex1p's count of uniform refinements of a 2-D mesh of 2·nx·ny
    triangles: ``floor(log(max / NE) / log(2) / dim)`` serial ones, then
    the parallel ones."""
    serial = int(math.floor(math.log(max_serial_elements / (2.0 * nx * ny))
                            / math.log(2.0) / 2))
    return max(serial, 0) + par_ref_levels


def mesh(nx: int, ny: int, sx: float, sy: float):
    """(points, triangles, interior mask) of the inline triangle mesh."""
    px = np.linspace(0.0, sx, nx + 1)
    py = np.linspace(0.0, sy, ny + 1)
    gx, gy = np.meshgrid(px, py)
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    v = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    sw, se = v[:-1, :-1].ravel(), v[:-1, 1:].ravel()
    ne, nw = v[1:, 1:].ravel(), v[1:, :-1].ravel()
    tris = np.concatenate([np.stack([sw, se, ne], 1),
                           np.stack([ne, nw, sw], 1)])
    i, j = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1))
    interior = ((i > 0) & (i < nx) & (j > 0) & (j < ny)).ravel()
    return pts, tris, interior


def assemble(pts, tris):
    """The P1 stiffness matrix of −Δ, as a scipy CSR with the element
    matrices' entries summed (zeros of an element matrix skipped)."""
    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    det = e1[:, 0] * e2[:, 1] - e2[:, 0] * e1[:, 1]
    area = np.abs(det) / 2.0
    # the inverse Jacobian, rows (x, y) of the reference gradients' map
    jinv = np.stack([np.stack([e2[:, 1], -e2[:, 0]], 1),
                     np.stack([-e1[:, 1], e1[:, 0]], 1)], 1) / det[:, None, None]
    gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    g = np.einsum("ab,tbc->tac", gref, jinv)
    ke = area[:, None, None] * np.einsum("tac,tbc->tab", g, g)
    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    vals = ke.ravel()
    keep = vals != 0.0
    n = len(pts)
    a = sps.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                       shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def make(config: dict) -> dict:
    nx, ny = int(config["nx"]), int(config["ny"])
    scale = 2 ** refinements(nx, ny, int(config["max_serial_elements"]),
                             int(config["par_ref_levels"]))
    pts, tris, interior = mesh(nx * scale, ny * scale, float(config["sx"]),
                               float(config["sy"]))
    a = assemble(pts, tris)
    keep = np.flatnonzero(interior)
    a = a[keep][:, keep].tocsr()
    a.sort_indices()
    return dict(indptr=a.indptr.astype(np.int64),
                indices=a.indices.astype(np.int32),
                data=a.data.astype(np.float64))
