"""Block smoother: non-overlapping additive Schwarz with diagonal
compensation.

Reference ``BlockSmoother`` (block_smoothers.rs:89-241): per aggregate of
a partition, extract the local dense block of A, *compensate* the diagonal
for cut edges so the block stays an SPD upper bound:

- scalar dofs: dᵢ += 0.5·√(aᵢᵢ/aⱼⱼ)·|aᵢⱼ| per cut edge (i,j)
  (block_smoothers.rs:293-324),
- vector dofs (block_size>1): per cut block pair accumulate
  0.5·U·|S|·Uᵀ from the SVD of −A_IJ onto the diagonal block
  (block_smoothers.rs:326-399),

then invert each block and apply as gather → per-block solve → scatter.

Aggregates are grouped into size buckets (instead of padding everything
to the global max); the per-block inverses are materialized once at
setup on the host via batched Cholesky (the reference's
``into_sparse_mat`` analog, block_smoothers.rs:125-146), so each
application is one batched (n_b, s_b, s_b) × (n_b, s_b[, k]) matmul per
bucket plus one gather and one disjoint scatter-add on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.sparse.csr import CSR


@dataclasses.dataclass
class BlockBucket:
    """Aggregates padded to one common size s_b."""

    inv_blocks: torch.Tensor  # (n_b, s_b, s_b) materialized block inverses
    idx: torch.Tensor  # (n_b, s_b) int64 dof indices, padded with 0
    mask: torch.Tensor  # (n_b, s_b) 1.0 valid / 0.0 padding


@dataclasses.dataclass
class BlockSmoother(LinearOperator):
    buckets: Tuple[BlockBucket, ...]
    n: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def _apply(self, x):
        out = torch.zeros((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        tail = (1,) * (x.dim() - 1)
        for b in self.buckets:
            mask = b.mask.reshape(b.mask.shape + tail)
            rhs = x[b.idx] * mask  # (n_b, s_b[, k])
            if x.dim() == 1:
                sol = torch.bmm(b.inv_blocks, rhs[..., None])[..., 0]
            else:
                sol = torch.bmm(b.inv_blocks, rhs)
            out.index_add_(0, b.idx.reshape(-1),
                           (sol * mask).reshape((-1,) + tuple(x.shape[1:])))
        return out

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)

    # ------------------------------------------------------------------
    @staticmethod
    def build(a: CSR, partition: Partition, device,
              dtype=torch.float64) -> "BlockSmoother":
        """Assemble from a host CSR matrix and a partition of its dofs.

        ``partition`` partitions *scalar* dofs; when ``a.block_size > 1``
        aggregates must contain whole blocks (guaranteed when the
        partition came from a block-contracted graph, reference
        partitioners/mod.rs:294-301).
        """
        n = a.nrows
        if partition.num_nodes != n:
            raise ValueError(
                f"partition covers {partition.num_nodes} dofs, matrix has {n}"
            )
        bs = a.block_size
        node_to_agg = partition.node_to_agg
        n_aggs = partition.num_aggs
        comp = _diag_compensation(a, node_to_agg, bs)

        # local rank of each dof within its (ascending-sorted) aggregate
        order = np.argsort(node_to_agg, kind="stable")
        sizes = np.bincount(node_to_agg, minlength=n_aggs)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        local_rank = np.empty(n, dtype=np.int64)
        local_rank[order] = np.arange(n) - np.repeat(starts, sizes)

        # size buckets: multiples of 64 above 8 (≤1.25x padding for the
        # big cf≈128-256 smoother blocks whose inversion dominates setup;
        # a power-of-two scheme would pad 257→512 = 8x the flops)
        padded = np.where(
            sizes <= 8, 8, ((np.maximum(sizes, 1) + 63) // 64) * 64
        ).astype(np.int64)
        rows, cols, vals = a.coo()
        intra = node_to_agg[rows] == node_to_agg[cols]
        ri, ci, vi = rows[intra], cols[intra], vals[intra]
        agg_i = node_to_agg[ri]
        # factor in the target precision: the inverse is applied in it
        fdt = np.float32 if dtype == torch.float32 else np.float64

        buckets = []
        for s_b in np.unique(padded):
            agg_sel = np.flatnonzero(padded == s_b)
            n_b = len(agg_sel)
            slot = -np.ones(n_aggs, dtype=np.int64)
            slot[agg_sel] = np.arange(n_b)
            sizes_b = sizes[agg_sel]

            blocks = np.zeros((n_b, s_b, s_b))
            # one vectorized scatter of all intra-aggregate entries
            in_b = slot[agg_i] >= 0
            blocks[slot[agg_i[in_b]], local_rank[ri[in_b]],
                   local_rank[ci[in_b]]] = vi[in_b]
            # identity on padded diagonal slots
            jj = np.arange(s_b)
            pad_mask = jj[None, :] >= sizes_b[:, None]
            blocks[np.arange(n_b)[:, None], jj[None, :], jj[None, :]] += (
                pad_mask.astype(np.float64)
            )
            # diagonal compensation
            if bs == 1:
                dofs_b = np.flatnonzero(slot[node_to_agg] >= 0)
                np.add.at(
                    blocks,
                    (slot[node_to_agg[dofs_b]], local_rank[dofs_b],
                     local_rank[dofs_b]),
                    comp[dofs_b],
                )
            else:
                blk_ids = np.flatnonzero(
                    slot[node_to_agg[np.arange(0, n, bs)]] >= 0
                )
                if len(blk_ids):
                    first_dof = blk_ids * bs
                    ag = node_to_agg[first_dof]
                    ls = local_rank[first_dof]
                    ar = np.arange(bs)
                    np.add.at(
                        blocks,
                        (
                            slot[ag][:, None, None],
                            ls[:, None, None] + ar[None, :, None],
                            ls[:, None, None] + ar[None, None, :],
                        ),
                        comp[blk_ids],
                    )

            idx = np.zeros((n_b, s_b), dtype=np.int64)
            mask = np.zeros((n_b, s_b))
            dofs_b = np.flatnonzero(slot[node_to_agg] >= 0)
            idx[slot[node_to_agg[dofs_b]], local_rank[dofs_b]] = dofs_b
            mask[slot[node_to_agg[dofs_b]], local_rank[dofs_b]] = 1.0
            inv = _spd_inverse(np.ascontiguousarray(blocks, fdt))
            buckets.append(
                BlockBucket(
                    inv_blocks=to_device(inv, device, dtype),
                    idx=to_device(idx, device),
                    mask=to_device(mask, device, dtype),
                )
            )
        return BlockSmoother(buckets=tuple(buckets), n=n)


def _spd_inverse(blocks: np.ndarray) -> np.ndarray:
    """Batched SPD inverse via Cholesky (inv = L⁻ᵀL⁻¹); falls back to LU
    for blocks that fail the factorization (compensation guarantees SPD
    in exact arithmetic — block_smoothers.rs:293-399 — but roundoff can
    bite on near-singular aggregates)."""
    try:
        chol = np.linalg.cholesky(blocks)
    except np.linalg.LinAlgError:
        return np.linalg.inv(blocks)
    from scipy.linalg import get_lapack_funcs

    (trtri,) = get_lapack_funcs(("trtri",), (blocks,))
    linv = np.empty_like(chol)
    for k in range(chol.shape[0]):  # one LAPACK call per block
        linv[k], info = trtri(chol[k], lower=1)
        if info != 0:
            return np.linalg.inv(blocks)
    return np.matmul(linv.transpose(0, 2, 1), linv)


def _diag_compensation(a: CSR, node_to_agg: np.ndarray, bs: int):
    """Cut-edge diagonal compensation.

    Scalar case returns a (n,) vector of diagonal additions
    (block_smoothers.rs:293-324).  Block case returns a
    (n_blocks, bs, bs) array of diagonal-block additions computed with
    one batched SVD over all cut block pairs (block_smoothers.rs:326-399).
    """
    rows, cols, vals = a.coo()
    cut = node_to_agg[rows] != node_to_agg[cols]
    if bs == 1:
        diag = a.diagonal()
        comp = np.zeros(a.nrows)
        r, c, v = rows[cut], cols[cut], vals[cut]
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.sqrt(np.abs(diag[r]) / np.abs(diag[c]))
        scale = np.where(np.isfinite(scale), scale, 1.0)
        np.add.at(comp, r, 0.5 * scale * np.abs(v))
        return comp

    # block case: group cut entries by (block_row, block_col), form the
    # dense bs×bs coupling blocks, one batched SVD, accumulate 0.5·U|S|Uᵀ
    n_blocks = a.nrows // bs
    brows, bcols = rows // bs, cols // bs
    bcut = cut & (brows != bcols)
    comp = np.zeros((n_blocks, bs, bs))
    if not bcut.any():
        return comp
    r, c, v = rows[bcut], cols[bcut], vals[bcut]
    br, bc = brows[bcut], bcols[bcut]
    pair_key = br * (a.ncols // bs) + bc
    uniq, inv_idx = np.unique(pair_key, return_inverse=True)
    mats = np.zeros((len(uniq), bs, bs))
    mats[inv_idx, r % bs, c % bs] = -v
    u, s, _ = np.linalg.svd(mats)
    adds = 0.5 * np.einsum("pik,pk,pjk->pij", u, np.abs(s), u)
    np.add.at(comp, (uniq // (a.ncols // bs)), adds)
    return comp
