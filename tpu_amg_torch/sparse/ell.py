"""ELL (padded-row) sparse matrix on one device.

Port of ``tpu_amg/sparse/ell.py``: every row padded to a fixed width K
(the longest row, rounded up to ``pad_to``), padded slots ``col 0, val
0``, so that ``y[i] = Σ_k data[i, k] · x[cols[i, k]]``.  The fields,
shapes and methods are the JAX package's; ``nnz`` is the CSR's count of
stored entries, not a count of non-zeros.

**Apply.**  ``mv`` and ``mm`` (k ≤ 64 columns) run K1 + K2
(:func:`tpu_amg_torch.ops.spmv.spmv`) on a :class:`CappedCSR` built
once, with the container, from its stored slots with the padding
dropped: its rows, their order and its entries are the CSR's own
(``from_csr`` keeps the CSR's stored zeros; ``from_arrays``, which
cannot tell a stored zero from padding, keeps the non-zero slots).  So
an ELL applies at the cost of the CSR operator on the same matrix: K1
streams the stored entries alone.  Read through the padding instead,
K1 would move n·K values and indices: a smoothed-SA restriction, whose
hub rows run to several hundred entries against a mean near 8, would
cost tens of times its entries.  The padded ``data`` and ``cols`` stay
beside it for the JAX package's reductions (``diagonal``, row sums) and
for sharding.  Nothing is built or allocated on the host during an
apply, so a CUDA graph captures it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.sparse.csr import CSR


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def to_host(t) -> np.ndarray:
    """A tensor (any dtype, any device) or an array as a numpy array;
    floating values widened to float64 exactly."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.to(torch.float64)
        return t.numpy()
    return np.asarray(t)


def capped_from_slots(vals, cols, keep, shape, device, dtype) -> CappedCSR:
    """The :class:`CappedCSR` of the slots ``keep`` of a row-major slot
    table: ``vals`` and ``cols`` (n, S) numpy arrays, each row's kept
    slots in their order."""
    keep = np.asarray(keep, dtype=bool)
    indptr = np.zeros(keep.shape[0] + 1, dtype=np.int64)
    np.cumsum(keep.sum(1), out=indptr[1:])
    csr = CSR(data=np.asarray(vals, dtype=np.float64)[keep],
              indices=np.asarray(cols)[keep].astype(np.int32),
              indptr=indptr, shape=tuple(shape))
    return CappedCSR.from_csr(csr, device, dtype)


@dataclasses.dataclass
class ELL:
    """Padded-row sparse matrix on one device.

    Attributes:
      data: (nrows, K) values, padded with 0.
      cols: (nrows, K) int32 column indices, padded with 0.
      shape: (nrows, ncols).
      nnz: the stored entries of the CSR it came from.
      block_size: block-size metadata (reference core.rs:22-36).
      capped: the stored slots as K1 + K2 apply them (module docstring).
    """

    data: torch.Tensor
    cols: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    block_size: int = 1
    capped: CappedCSR = dataclasses.field(default=None, repr=False)

    @staticmethod
    def from_csr(csr: CSR, device, dtype=torch.float64,
                 pad_to: int = 1) -> "ELL":
        """A host CSR as an ELL on ``device``; ``pad_to`` rounds K up."""
        nrows, ncols = csr.shape
        row_nnz = csr.row_nnz()
        k = _round_up(max(int(row_nnz.max(initial=0)), 1), pad_to)
        data = np.zeros((nrows, k))
        cols = np.zeros((nrows, k), dtype=np.int32)
        offs = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
        rows = np.repeat(np.arange(nrows), row_nnz)
        data[rows, offs] = csr.data
        cols[rows, offs] = csr.indices
        keep = np.arange(k)[None, :] < row_nnz[:, None]
        return ELL._build(data, cols, csr.shape, csr.nnz, csr.block_size,
                          keep, device, dtype)

    @staticmethod
    def from_arrays(data, cols, shape, nnz: int, block_size: int, device,
                    dtype=torch.float64) -> "ELL":
        """An ELL on ``device`` from host arrays ``data`` and ``cols``
        (nrows, K), for example the JAX package's ``ELL`` fields as numpy
        arrays; K1 + K2 apply its non-zero slots."""
        data, cols = to_host(data), to_host(cols)
        if data.ndim != 2 or cols.shape != data.shape \
                or data.shape[0] != shape[0]:
            raise ValueError(f"data {data.shape}, cols {cols.shape}: not an "
                             f"ELL of shape {tuple(shape)}")
        return ELL._build(data, cols, shape, nnz, block_size, data != 0,
                          device, dtype)

    @staticmethod
    def _build(data, cols, shape, nnz, block_size, keep, device,
               dtype) -> "ELL":
        return ELL(data=to_device(data, device, dtype),
                   cols=to_device(cols, device, torch.int32),
                   shape=tuple(int(s) for s in shape), nnz=int(nnz),
                   block_size=int(block_size),
                   capped=capped_from_slots(data, cols, keep, shape, device,
                                            dtype))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def astype(self, dtype) -> "ELL":
        """The values in ``dtype``: the padded ``data`` and the
        :class:`CappedCSR` that applies them, cast together."""
        return dataclasses.replace(self, data=self.data.to(dtype),
                                   capped=self.capped.astype(dtype))

    def to_csr(self) -> CSR:
        """Host CSR of the non-zero slots (stored zeros dropped with the
        padding, as the JAX package's ``to_csr``)."""
        data, cols = to_host(self.data), to_host(self.cols).astype(np.int64)
        rows = np.broadcast_to(
            np.arange(self.nrows, dtype=np.int64)[:, None], cols.shape)
        keep = data != 0
        return CSR.from_coo(rows[keep], cols[keep], data[keep],
                            self.shape).with_block_size(self.block_size)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x through K1 + K2, in the promotion of the values' and
        x's dtypes (:func:`tpu_amg_torch.linop._apply`)."""
        from tpu_amg_torch.linop import _apply

        return _apply(self, x)

    def mm(self, xs: torch.Tensor) -> torch.Tensor:
        """Y = A X for X (ncols, k), k ≤ 64, through K1 + K2."""
        from tpu_amg_torch.linop import _apply

        return _apply(self, xs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x) if x.dim() > 1 else self.mv(x)

    def diagonal(self) -> torch.Tensor:
        """The diagonal of a square ELL: padded slots (col 0, val 0) are
        masked by ``data != 0``; a stored zero diagonal reads 0 anyway."""
        rows = torch.arange(self.nrows, device=self.device)[:, None]
        hit = (self.cols == rows) & (self.data != 0)
        return torch.where(hit, self.data, 0).sum(1)

    def abs_row_sums(self) -> torch.Tensor:
        """l1 row norms (the l1 smoother's diagonal, reference
        smoothers.rs:63-76)."""
        return self.data.abs().sum(1)

    def row_sums(self) -> torch.Tensor:
        return self.data.sum(1)

    def __repr__(self):
        return (f"ELL(shape={self.shape}, nnz={self.nnz}, k={self.k}, "
                f"dtype={self.dtype}, block_size={self.block_size})")
