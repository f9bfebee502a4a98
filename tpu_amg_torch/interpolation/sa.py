"""Smoothed-aggregation interpolation.

Reference ``AggregationConfig`` + ``smoothed_aggregation``
(interpolation/mod.rs:62-157, 730-836), host-side:

1. The partitioner's coarsening factor is scaled by
   candidate_dimension / block_size (mod.rs:135-137) so every aggregate
   can support ``candidate_dimension`` coarse dofs.
2. Per aggregate, the near-null rows are gathered into a local
   (agg_dofs × k) matrix and thin-SVD'd; the first ``candidate_dimension``
   left-singular columns form the tentative-P block, and S·Vᵀ's top rows
   become that aggregate's coarse near-null rows (mod.rs:763-801).
   Instead of the reference's serial per-aggregate SVD loop, all
   aggregates are padded to the max aggregate size and solved as ONE
   batched SVD — zero-padded rows do not perturb the row-space, so
   results match the unpadded SVDs exactly (up to sign).
3. ``smoothing_steps`` rounds of prolongation smoothing
   P ← P − 0.66·D⁻¹(A·P) with D = diag(A) for scalar dofs
   (smooth_interpolation, mod.rs:927-961) or the eigendecomposition-based
   block-Jacobi D_b⁻¹ for block_size > 1 (block_jacobi, mod.rs:963-1028).
4. R = Pᵀ materialized; Galerkin coarse A_c = R·(A·P) (mod.rs:824-828).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tpu_amg_torch.partition import Partition, PartitionerConfig
from tpu_amg_torch.sparse import CSR, sp_add, spgemm
from tpu_amg_torch.sparse.ops import from_coo

JACOBI_WEIGHT = 0.66  # prolongation-smoothing weight (mod.rs:814, 1015)


@dataclasses.dataclass(frozen=True)
class GalerkinCoarse:
    """Result of one coarsening step (reference GalerkinCoarse,
    interpolation/mod.rs:34-54)."""

    interpolation: CSR  # P: (n_fine, n_coarse)
    restriction: CSR  # R = Pᵀ
    coarse_mat: CSR  # A_c = R A P
    coarse_nn: np.ndarray  # (n_coarse, k) coarse near-null rows
    partition: Partition  # aggregation partition (or C/F split)
    kind: str = "aggregation"


@dataclasses.dataclass
class AggregationConfig:
    """Defaults: smoothing_steps 1, candidate_dimension 4
    (reference mod.rs:71-79)."""

    smoothing_steps: int = 1
    candidate_dimension: int = 4
    filter_theta: Optional[float] = None  # filtered-SA P smoothing
    trunc_tol: Optional[float] = None  # P truncation (truncate_prolongator)
    partitioner_config: PartitionerConfig = dataclasses.field(
        default_factory=PartitionerConfig
    )

    def build(
        self,
        a: CSR,
        near_null: np.ndarray,
        nn_weights: np.ndarray,
        partition: Optional[Partition] = None,
    ) -> GalerkinCoarse:
        near_null = np.asarray(near_null, dtype=np.float64)
        if near_null.ndim == 1:
            near_null = near_null[:, None]
        if partition is None:
            ratio = self.candidate_dimension / a.block_size
            p_config = dataclasses.replace(
                self.partitioner_config,
                coarsening_factor=self.partitioner_config.coarsening_factor
                * ratio,
                # the per-aggregate SVD needs agg_size*block_size >= cd;
                # merge undersized aggregates instead of panicking like
                # the reference (interpolation/mod.rs:756-761)
                min_agg_size=max(
                    self.partitioner_config.min_agg_size,
                    -(-self.candidate_dimension // max(a.block_size, 1)),
                ),
            )
            partition = p_config.build_partition(a, near_null, nn_weights)
        return smoothed_aggregation(
            a,
            partition,
            near_null,
            self.candidate_dimension,
            self.smoothing_steps,
            filter_theta=self.filter_theta,
            trunc_tol=self.trunc_tol,
        )


def smoothed_aggregation(
    a: CSR,
    partition: Partition,
    near_null: np.ndarray,
    candidate_dimension: int,
    smoothing_steps: int,
    filter_theta: float = None,
    trunc_tol: float = None,
) -> GalerkinCoarse:
    """Build tentative + smoothed P from a block-node partition."""
    n = a.nrows
    bs = a.block_size
    cd = candidate_dimension
    k = near_null.shape[1]
    if partition.num_nodes * bs != n:
        raise ValueError(
            f"partition over {partition.num_nodes} block-nodes does not "
            f"match {n} dofs with block_size {bs}"
        )
    scalar_part = partition.expand_blocks(bs)
    agg_lists = scalar_part.agg_lists()
    n_aggs = len(agg_lists)
    sizes = np.array([len(g) for g in agg_lists])
    if sizes.min() < cd:
        # reference asserts (mod.rs:756-761)
        raise ValueError(
            f"aggregate of {sizes.min()} dofs cannot support candidate "
            f"dimension {cd}"
        )

    # ---- batched tentative prolongator: pad to bmax and one batched SVD
    bmax = int(sizes.max())
    idx = np.zeros((n_aggs, bmax), dtype=np.int64)
    mask = np.zeros((n_aggs, bmax), dtype=bool)
    for g, dofs in enumerate(agg_lists):
        idx[g, : len(dofs)] = dofs
        mask[g, : len(dofs)] = True
    local = near_null[idx] * mask[:, :, None]  # (n_aggs, bmax, k)
    u, s, vh = np.linalg.svd(local, full_matrices=False)
    # tentative P blocks: first cd left-singular columns (masked rows)
    u_cd = u[:, :, :cd] * mask[:, :, None]
    # coarse near-null rows: (S·Vᵀ) top cd rows per aggregate
    coarse_nn = (s[:, :cd, None] * vh[:, :cd, :]).reshape(n_aggs * cd, k)

    rows = np.repeat(idx.reshape(-1), cd)
    cols = (
        (np.arange(n_aggs)[:, None, None] * cd)
        + np.arange(cd)[None, None, :]
        + np.zeros((1, bmax, 1), dtype=np.int64)
    ).reshape(-1)
    vals = u_cd.reshape(-1)
    keep = np.repeat(mask.reshape(-1), cd)
    p = from_coo(
        rows[keep], cols[keep], vals[keep], (n, n_aggs * cd)
    )

    # ---- prolongation smoothing
    for _ in range(smoothing_steps):
        if bs == 1:
            p = smooth_interpolation(
                a, p, JACOBI_WEIGHT, filter_theta=filter_theta
            )
        else:
            p = block_jacobi_smooth(a, p)
    if trunc_tol is not None and smoothing_steps > 0:
        p = truncate_prolongator(p, trunc_tol)

    r = p.transpose()
    ap = spgemm(a, p)
    coarse_mat = spgemm(r, ap).with_block_size(cd)
    return GalerkinCoarse(
        interpolation=p,
        restriction=r,
        coarse_mat=coarse_mat,
        coarse_nn=coarse_nn,
        partition=partition,
        kind="aggregation",
    )


def truncate_prolongator(p: CSR, tol: float) -> CSR:
    """Row-wise truncation of the smoothed prolongator: drop entries
    with |pᵢⱼ| < tol·maxⱼ|pᵢⱼ| and rescale the survivors so each row's
    L1 mass is preserved.

    Not in the reference (whose 2-D problems keep RAP fill modest); on
    3-D meshes (~16 nnz/row) one smoothing step widens every aggregate's
    Galerkin stencil to its full 2-hop aggregate neighborhood — measured
    op complexity 3.56 at 1M dofs, with 150+ coarse nnz/row — and
    truncation is the standard SA fill control (ML/PyAMG practice).
    """
    n = p.nrows
    absd = np.abs(p.data)
    deg = np.diff(p.indptr)
    nz = deg > 0
    starts = p.indptr[:-1]
    rowmax = np.zeros(n)
    rowmax[nz] = np.maximum.reduceat(absd, starts[nz])
    rows = np.repeat(np.arange(n), deg)
    keep = absd >= tol * rowmax[rows]
    l1_full = np.zeros(n)
    l1_full[nz] = np.add.reduceat(absd, starts[nz])
    kept_abs = np.where(keep, absd, 0.0)
    l1_kept = np.zeros(n)
    l1_kept[nz] = np.add.reduceat(kept_abs, starts[nz])
    scale = np.where(l1_kept > 0, l1_full / np.maximum(l1_kept, 1e-300), 1.0)
    data = (p.data * scale[rows])[keep]
    return from_coo(
        rows[keep], p.indices[keep], data, p.shape, p.block_size
    )


def filter_matrix(a: CSR, theta: float, lump_abs: bool = False) -> CSR:
    """Strength-filtered A for prolongation smoothing: drop off-diagonal
    entries with |aᵢⱼ| < θ·√(aᵢᵢ·aⱼⱼ) and lump them into the diagonal.
    For block matrices only entries OUTSIDE the block diagonal are
    dropped — lumping intra-block couplings onto the scalar diagonal
    can leave the bs×bs diagonal blocks indefinite.

    ``lump_abs=False`` preserves row sums (the right choice when the
    result only smooths P).  ``lump_abs=True`` lumps |a_ij| instead:
    each dropped symmetric pair then adds the PSD update
    [[|v|, -v], [-v, |v|]], so the sparsified operator stays SPD — the
    required choice when the result IS the coarse operator
    (hierarchy.py coarse_drop_tol; signed lumping shrank diagonals
    enough at 1M dofs to turn cd=2 diagonal blocks indefinite).

    Not in the reference (whose plain-Jacobi P smoothing re-couples
    across coefficient jumps); standard filtered-SA improvement for
    high-contrast problems.
    """
    rows, cols, vals = a.coo()
    diag = a.diagonal()
    bs = max(a.block_size, 1)
    off = (rows // bs) != (cols // bs) if bs > 1 else rows != cols
    weak = off & (
        np.abs(vals) < theta * np.sqrt(np.abs(diag[rows] * diag[cols]))
    )
    lump = np.zeros(a.nrows)
    lv = np.abs(vals[weak]) if lump_abs else vals[weak]
    np.add.at(lump, rows[weak], lv)
    keep = ~weak
    rows_k = np.concatenate([rows[keep], np.arange(a.nrows)])
    cols_k = np.concatenate([cols[keep], np.arange(a.nrows)])
    vals_k = np.concatenate([vals[keep], lump])
    return CSR.from_coo(rows_k, cols_k, vals_k, a.shape, a.block_size)


def smooth_interpolation(
    a: CSR,
    p: CSR,
    weight: float = JACOBI_WEIGHT,
    filter_theta: float = None,
) -> CSR:
    """P ← P − ω·D⁻¹·(A·P), D = diag(A)
    (reference smooth_interpolation, mod.rs:927-961).

    ``filter_theta`` smooths with the strength-filtered A instead
    (see :func:`filter_matrix`) — better P for high-contrast coefficients.
    """
    if filter_theta is not None:
        a = filter_matrix(a, filter_theta)
    diag = a.diagonal()
    if (diag <= 1e-6).any():
        raise ValueError("diagonal nearly zero in prolongation smoothing")
    ap = spgemm(a, p)
    scaled = dataclasses.replace(
        ap,
        data=ap.data * (-weight / diag)[np.repeat(np.arange(a.nrows), ap.row_nnz())],
    )
    return sp_add(p, scaled)


def block_jacobi_smooth(a: CSR, p: CSR, weight: float = JACOBI_WEIGHT) -> CSR:
    """P ← P − ω·D_b⁻¹·(A·P) with D_b the bs×bs block diagonal of A,
    inverted via eigendecomposition (reference block_jacobi,
    mod.rs:963-1028; asserts eigenvalues > 1e-6)."""
    bs = a.block_size
    n = a.nrows
    n_blocks = n // bs
    # extract block diagonal as (n_blocks, bs, bs), batched eigh inverse
    blocks = np.zeros((n_blocks, bs, bs))
    rows, cols, vals = a.coo()
    on_diag = (rows // bs) == (cols // bs)
    r, c, v = rows[on_diag], cols[on_diag], vals[on_diag]
    blocks[r // bs, r % bs, c % bs] = v
    w, q = np.linalg.eigh(blocks)
    if (w <= 1e-6).any():
        raise ValueError(
            f"block diagonal nearly singular: min eig {w.min():.3e}"
        )
    inv = np.einsum("bij,bj,bkj->bik", q, 1.0 / w, q)
    # assemble sparse block-diagonal -ω·D_b⁻¹
    bi = np.arange(n_blocks)[:, None, None]
    rr = (bi * bs + np.arange(bs)[None, :, None]).repeat(bs, axis=2)
    cc = (bi * bs + np.arange(bs)[None, None, :]).repeat(bs, axis=1)
    d_inv = from_coo(
        rr.reshape(-1), cc.reshape(-1), (-weight * inv).reshape(-1), (n, n)
    )
    smoothed = spgemm(d_inv, spgemm(a, p))
    return sp_add(p, smoothed)
