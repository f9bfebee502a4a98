"""DIA (diagonal) sparse format on one device.

For matrices whose nonzeros fall on a few (off-)diagonals (structured
grid stencils and their Galerkin coarse operators) storing one value
vector per diagonal drops the column-index stream entirely:

    y = Σ_d  data_d ⊙ shift(x, offset_d)

The apply is K3 (:mod:`tpu_amg_torch.ops.dia`), a hand-written CUDA
kernel; its plain PyTorch version runs on the CPU.  Both routed designs
take the offsets by value in the launch (below k = 8 the row-chunk
design's table, from k = 8 up the band plan ``ops.dia.dia_plan``, a
pure function of the offsets and shapes), so the matrix carries
nothing else to the device and a CUDA graph captured with it holds no
stale table; only the first design, K3's reference on the card, reads
``offsets_dev``.
Port of
``tpu_amg/sparse/dia.py``; :func:`try_from_csr` returns None when the
matrix is not square or has too many distinct diagonals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.dia import dia_spmv
from tpu_amg_torch.sparse.csr import CSR


@dataclasses.dataclass
class DIA:
    """Diagonal-format square sparse matrix on one device.

    ``data[d, i] = A[i, i + offsets[d]]`` (0 where out of range or not
    stored), shape (n_diags, n).  ``offsets`` is kept twice: as a
    strictly increasing Python tuple and as an int64 tensor on the data's
    device, which the kernel's first design (the reference) reads."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    offsets_dev: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    block_size: int = 1

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

    def astype(self, dtype) -> "DIA":
        return dataclasses.replace(self, data=self.data.to(dtype))

    @staticmethod
    def from_csr(csr: CSR, device, dtype=torch.float64) -> "DIA":
        dia = try_from_csr(csr, device, dtype, max_diags=None)
        if dia is None:
            raise ValueError(f"DIA needs a square matrix, got {csr.shape}")
        return dia

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv(self, x)

    def mm(self, xs: torch.Tensor) -> torch.Tensor:
        return dia_spmv(self, xs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv(self, x)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.nrows, dtype=self.dtype, device=self.device)

    def abs_row_sums(self) -> torch.Tensor:
        return self.data.abs().sum(0)

    def row_sums(self) -> torch.Tensor:
        return self.data.sum(0)


def dia_from_arrays(data, offsets: Sequence[int], shape: Tuple[int, int],
                    nnz: int, device, dtype=torch.float64,
                    block_size: int = 1) -> DIA:
    """A :class:`DIA` on ``device`` from host arrays: ``data`` (n_diags,
    n) and strictly increasing ``offsets`` (for example the fields of the
    JAX package's ``DIA``, as numpy arrays): K3 sums and stages the
    diagonals in that order."""
    offsets = tuple(int(o) for o in offsets)
    if any(b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets {offsets} are not strictly increasing")
    data = to_device(data, device, dtype).contiguous()
    if data.shape != (len(offsets), shape[0]) or shape[0] != shape[1]:
        raise ValueError(f"data {tuple(data.shape)}, {len(offsets)} offsets, "
                         f"shape {shape}: not a square DIA")
    return DIA(
        data=data,
        offsets=offsets,
        offsets_dev=torch.tensor(offsets, dtype=torch.int64, device=data.device),
        shape=tuple(shape),
        nnz=int(nnz),
        block_size=block_size,
    )


def try_from_csr(csr: CSR, device, dtype=torch.float64,
                 max_diags: Optional[int] = 32) -> Optional[DIA]:
    """Convert when the matrix is square and has at most ``max_diags``
    distinct diagonals (None: no limit); otherwise return None."""
    if not csr.is_square:
        return None
    rows, cols, vals = csr.coo()
    offs = cols - rows
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        return None
    data = np.zeros((len(uniq), csr.nrows))
    data[np.searchsorted(uniq, offs), rows] = vals
    return dia_from_arrays(data, uniq, csr.shape, csr.nnz, device, dtype,
                           csr.block_size)
