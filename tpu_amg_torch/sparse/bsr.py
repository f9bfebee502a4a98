"""BSR (block-sparse row) matrix on one device.

Port of ``tpu_amg/sparse/bsr.py``, the JAX package's format for the
block-structured levels (block-3 elasticity, the cd × cd blocks of SA
coarse operators).  Layout: block rows padded to K blocks (ELL of
blocks), ``data`` (n_brows, K, bs, bs), ``cols`` (n_brows, K) block
columns, padding a zero block at block column 0; a block row's blocks
in increasing block column.

**Apply.**  ``mv`` and ``mm`` (k ≤ 64) run K1 + K2 on a
:class:`CappedCSR` built once, with the container, from the stored
blocks with the padding blocks dropped: scalar row ``b·bs + r`` holds
row r of each of block row b's blocks, in block-column order, so the
rows and their order are the CSR's.  Zeros inside a stored block are
not kept: ``from_csr`` keeps the entries the CSR stored (its stored
zeros too) and ``from_arrays`` the non-zero ones.  A BSR from a CSR is
therefore applied at the CSR operator's cost, and spills to K2 exactly
where the CSR does; a row of K·bs slots read whole would move every
zero of a partly filled block and spill past the cap sooner.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ell import capped_from_slots, to_host


def _scalar_slots(a: np.ndarray, bs: int) -> np.ndarray:
    """(n_brows, K, bs, bs) block entries as (n_brows·bs, K·bs) scalar
    row slots."""
    nb, k = a.shape[:2]
    return a.transpose(0, 2, 1, 3).reshape(nb * bs, k * bs)


@dataclasses.dataclass
class BSR:
    data: torch.Tensor  # (n_brows, K, bs, bs)
    cols: torch.Tensor  # (n_brows, K) int32 block columns
    shape: Tuple[int, int]
    nnz: int
    block_size: int
    capped: CappedCSR = dataclasses.field(default=None, repr=False)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_csr(csr: CSR, device, block_size: int = None,
                 dtype=torch.float64) -> "BSR":
        """A host CSR as a BSR of ``block_size`` (the CSR's own when
        None) on ``device``; raises ``ValueError`` where bs does not
        divide the shape."""
        bs = block_size or csr.block_size
        nr, nc = csr.shape
        if nr % bs or nc % bs:
            raise ValueError(f"dims {csr.shape} not divisible by bs={bs}")
        rows, cols, vals = csr.coo()
        nbc = nc // bs
        # unique block pairs, sorted by (block row, block column)
        uniq, inv = np.unique((rows // bs) * nbc + cols // bs,
                              return_inverse=True)
        ubr, ubc = uniq // nbc, uniq % nbc
        n_brows = nr // bs
        counts = np.bincount(ubr, minlength=n_brows)
        kmax = max(int(counts.max(initial=0)), 1)
        starts = np.zeros(n_brows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(len(uniq)) - starts[ubr]
        data = np.zeros((n_brows, kmax, bs, bs))
        colsb = np.zeros((n_brows, kmax), dtype=np.int32)
        colsb[ubr, slot] = ubc
        at = (ubr[inv], slot[inv], rows % bs, cols % bs)
        data[at] = vals
        stored = np.zeros(data.shape, dtype=bool)
        stored[at] = True
        return BSR._build(data, colsb, csr.shape, csr.nnz, bs, stored,
                          device, dtype)

    @staticmethod
    def from_arrays(data, cols, shape, nnz: int, block_size: int, device,
                    dtype=torch.float64) -> "BSR":
        """A BSR on ``device`` from host arrays ``data`` (n_brows, K, bs,
        bs) and ``cols`` (n_brows, K), for example the JAX package's
        ``BSR`` fields as numpy arrays; K1 + K2 apply the non-zero
        entries of its blocks."""
        data, cols = to_host(data), to_host(cols)
        bs = block_size
        if (data.ndim != 4 or data.shape[2:] != (bs, bs)
                or cols.shape != data.shape[:2]
                or data.shape[0] * bs != shape[0]):
            raise ValueError(f"data {data.shape}, cols {cols.shape}: not a "
                             f"BSR of shape {tuple(shape)}, bs={bs}")
        return BSR._build(data, cols, shape, nnz, bs, data != 0, device,
                          dtype)

    @staticmethod
    def _build(data, cols, shape, nnz, bs, keep, device, dtype) -> "BSR":
        scalar_cols = (cols.astype(np.int64)[:, None, :, None] * bs
                       + np.arange(bs)[None, None, None, :])
        scalar_cols = np.broadcast_to(scalar_cols, (cols.shape[0], bs,
                                                    cols.shape[1], bs))
        capped = capped_from_slots(
            _scalar_slots(data, bs),
            scalar_cols.reshape(cols.shape[0] * bs, cols.shape[1] * bs),
            _scalar_slots(keep, bs), shape, device, dtype)
        return BSR(data=to_device(data, device, dtype),
                   cols=to_device(cols, device, torch.int32),
                   shape=tuple(int(s) for s in shape), nnz=int(nnz),
                   block_size=int(bs), capped=capped)

    def astype(self, dtype) -> "BSR":
        """The blocks and the :class:`CappedCSR` that applies them, cast
        together."""
        return dataclasses.replace(self, data=self.data.to(dtype),
                                   capped=self.capped.astype(dtype))

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        from tpu_amg_torch.linop import _apply

        return _apply(self, x)

    def mm(self, xs: torch.Tensor) -> torch.Tensor:
        from tpu_amg_torch.linop import _apply

        return _apply(self, xs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x) if x.dim() > 1 else self.mv(x)

    def diagonal(self) -> torch.Tensor:
        """The diagonal entries of the blocks on the block diagonal."""
        brows = torch.arange(self.nrows // self.block_size,
                             device=self.device)[:, None]
        hit = (self.cols == brows).to(self.dtype)
        blocks = torch.einsum("nk,nkij->nij", hit, self.data)
        return torch.diagonal(blocks, dim1=1, dim2=2).reshape(-1)

    def abs_row_sums(self) -> torch.Tensor:
        return self.data.abs().sum((1, 3)).reshape(-1)

    def row_sums(self) -> torch.Tensor:
        return self.data.sum((1, 3)).reshape(-1)
