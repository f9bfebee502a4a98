"""MFEM linear-system and MatrixMarket I/O.

Reference ``load_mfem_linear_system`` (utils.rs:269-350) and helpers
(utils.rs:352-551): loads ``<name>.mtx`` (MatrixMarket, symmetric
expansion + zero dropping), ``.bdy`` (count-prefixed boundary dof
indices), ``.coords`` (whitespace rows), ``.rhs`` (column-major flat),
and applies Dirichlet boundary row/col elimination with old↔new index
maps.  Host numpy, the same parsing and writing as the JAX package's
``tpu_amg/utils/io.py``: a file written by either package reads the
same in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

from tpu_amg_torch.sparse.csr import CSR


def load_matrix_market(path) -> CSR:
    """Parse a MatrixMarket coordinate file into CSR, expanding symmetric
    storage and dropping explicit zeros (reference utils.rs:508-534)."""
    path = Path(path)
    with open(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError(f"{path} is not a MatrixMarket file")
        parts = header.split()
        if "coordinate" not in parts:
            raise ValueError("only coordinate (sparse) MatrixMarket supported")
        symmetric = "symmetric" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, ndmin=2)
    if data.size == 0:
        rows = cols = np.zeros(0, dtype=np.int64)
        vals = np.zeros(0)
    else:
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = (
            data[:, 2] if data.shape[1] > 2 else np.ones(len(rows))
        )
    nz = vals != 0.0
    rows, cols, vals = rows[nz], cols[nz], vals[nz]
    if symmetric:
        off = rows != cols
        rows, cols = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
        )
        vals = np.concatenate([vals, vals[off]])
    return CSR.from_coo(rows, cols, vals, (nrows, ncols))


def save_matrix_market(path, a: CSR, symmetric: bool = False) -> None:
    rows, cols, vals = a.coo()
    if symmetric:
        keep = rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    with open(path, "w") as f:
        kind = "symmetric" if symmetric else "general"
        f.write(f"%%MatrixMarket matrix coordinate real {kind}\n")
        f.write(f"{a.nrows} {a.ncols} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")


@dataclasses.dataclass
class IndexMapping:
    """reference MfemIndexMapping (utils.rs:250-257)."""

    mesh_to_solution: np.ndarray  # (-1 for removed boundary nodes)
    solution_to_mesh: np.ndarray


@dataclasses.dataclass
class MeshGeometry:
    """Triangle surface mesh for visualization (the sci-bevy-comm
    MeshGeometry role, reference utils.rs:28, 332-336)."""

    points: np.ndarray  # (n_pts, 3)
    cells: np.ndarray  # (n_tri, 3) int vertex indices


@dataclasses.dataclass
class MfemLinearSystem:
    """reference MfemLinearSystem (utils.rs:258-267)."""

    matrix: CSR
    rhs: np.ndarray  # (n, n_rhs)
    coords: np.ndarray  # (n, dim)
    boundary_indices: np.ndarray
    index_mapping: IndexMapping
    original_dimension: int
    mesh_geometry: Optional[MeshGeometry] = None


def load_vtk_triangle_mesh(path) -> MeshGeometry:
    """Parse a legacy-ASCII VTK file into points + triangle cells (the
    load_triangle_mesh_data role, reference utils.rs:28, 332-334).

    Handles POLYDATA ``POLYGONS`` and UNSTRUCTURED_GRID ``CELLS`` +
    ``CELL_TYPES`` (triangles = VTK type 5); polygons with more than 3
    vertices are fan-triangulated.
    """
    tokens = []
    with open(path) as f:
        lines = f.readlines()
    if len(lines) >= 3 and "ascii" not in lines[2].strip().lower():
        raise ValueError(f"{path}: only ASCII legacy VTK is supported")
    # tokenize everything after the 2-line header + format line
    for ln in lines[3:]:
        tokens.extend(ln.split())
    pos = 0

    def peek():
        return tokens[pos].upper() if pos < len(tokens) else None

    points = None
    conn = None  # flat connectivity [count, v0, v1, ..., count, ...]
    cell_types = None
    n_cells = 0
    while pos < len(tokens):
        tok = peek()
        if tok == "POINTS":
            n_pts = int(tokens[pos + 1])
            pos += 3  # POINTS n dtype
            points = np.array(
                tokens[pos : pos + 3 * n_pts], dtype=np.float64
            ).reshape(n_pts, 3)
            pos += 3 * n_pts
        elif tok in ("POLYGONS", "CELLS"):
            n_cells = int(tokens[pos + 1])
            size = int(tokens[pos + 2])
            pos += 3
            conn = np.array(tokens[pos : pos + size], dtype=np.int64)
            pos += size
        elif tok == "CELL_TYPES":
            n_ct = int(tokens[pos + 1])
            pos += 2
            cell_types = np.array(
                tokens[pos : pos + n_ct], dtype=np.int64
            )
            pos += n_ct
        else:
            pos += 1
    if points is None:
        raise ValueError(f"{path}: no POINTS section")
    tris: List[List[int]] = []
    if conn is not None:
        i = 0
        ci = 0
        while i < len(conn):
            cnt = int(conn[i])
            verts = conn[i + 1 : i + 1 + cnt]
            i += 1 + cnt
            is_tri_type = cell_types is None or (
                ci < len(cell_types) and cell_types[ci] in (5, 7, 9)
            )  # triangle / polygon / quad
            ci += 1
            if cnt >= 3 and is_tri_type:
                for k in range(1, cnt - 1):  # fan triangulation
                    tris.append([verts[0], verts[k], verts[k + 1]])
    cells = (
        np.array(tris, dtype=np.int64)
        if tris
        else np.zeros((0, 3), dtype=np.int64)
    )
    return MeshGeometry(points=points, cells=cells)


def find_associated_vtk(directory, name: str) -> Optional[Path]:
    """Walk from ``directory`` up through its parents looking for
    ``<name>.vtk`` (reference find_associated_vtk, utils.rs:536-551)."""
    current = Path(directory).resolve()
    while True:
        candidate = current / f"{name}.vtk"
        if candidate.is_file():
            return candidate
        if current.parent == current:
            return None
        current = current.parent


def load_mfem_linear_system(
    directory, name: str, delete_boundary: bool = True
) -> MfemLinearSystem:
    """Load <dir>/<name>.{mtx,bdy,coords,rhs} with optional Dirichlet
    elimination (reference utils.rs:269-350, 446-480)."""
    base = Path(directory) / name
    mtx = load_matrix_market(base.with_suffix(".mtx"))
    if not mtx.is_square:
        raise ValueError("MFEM loader supports only square matrices")
    n = mtx.nrows

    bdy_lines = base.with_suffix(".bdy").read_text().split()
    expected = int(bdy_lines[0])
    boundary = np.unique(np.array([int(t) for t in bdy_lines[1:]], dtype=np.int64))
    if len(bdy_lines) - 1 != expected:
        raise ValueError(
            f"boundary file: expected {expected} entries, found "
            f"{len(bdy_lines) - 1}"
        )

    coords = np.loadtxt(base.with_suffix(".coords"), ndmin=2)
    if coords.shape[0] != n:
        raise ValueError("coordinate rows must match matrix dimension")

    rhs_flat = np.fromstring(
        base.with_suffix(".rhs").read_text(), sep=" "
    )
    if len(rhs_flat) % n != 0:
        raise ValueError("RHS length must be a multiple of matrix dimension")
    rhs = rhs_flat.reshape(-1, n).T  # column-major flat (utils.rs:417-430)

    if delete_boundary:
        keep = np.setdiff1d(np.arange(n), boundary)
        mesh_to_solution = -np.ones(n, dtype=np.int64)
        mesh_to_solution[keep] = np.arange(len(keep))
        rows, cols, vals = mtx.coo()
        ok = (mesh_to_solution[rows] >= 0) & (mesh_to_solution[cols] >= 0)
        matrix = CSR.from_coo(
            mesh_to_solution[rows[ok]],
            mesh_to_solution[cols[ok]],
            vals[ok],
            (len(keep), len(keep)),
        )
        rhs = rhs[keep]
        coords = coords[keep]
        selection = keep
    else:
        matrix = mtx
        selection = np.arange(n)
        mesh_to_solution = np.arange(n)

    vtk_path = find_associated_vtk(directory, name)
    mesh_geometry = (
        load_vtk_triangle_mesh(vtk_path) if vtk_path is not None else None
    )

    return MfemLinearSystem(
        matrix=matrix,
        rhs=rhs,
        coords=coords,
        boundary_indices=boundary,
        index_mapping=IndexMapping(
            mesh_to_solution=mesh_to_solution, solution_to_mesh=selection
        ),
        original_dimension=n,
        mesh_geometry=mesh_geometry,
    )


def save_mfem_linear_system(
    directory, name: str, matrix: CSR, rhs: np.ndarray, coords: np.ndarray,
    boundary: np.ndarray,
) -> None:
    """Writer for round-trip tests and dataset generation."""
    base = Path(directory) / name
    save_matrix_market(base.with_suffix(".mtx"), matrix, symmetric=False)
    with open(base.with_suffix(".bdy"), "w") as f:
        f.write(f"{len(boundary)}\n")
        for b in boundary:
            f.write(f"{int(b)}\n")
    np.savetxt(base.with_suffix(".coords"), coords)
    rhs = np.asarray(rhs)
    if rhs.ndim == 1:
        rhs = rhs[:, None]
    with open(base.with_suffix(".rhs"), "w") as f:
        for col in rhs.T:
            f.write("\n".join(f"{v:.17g}" for v in col) + "\n")
