"""Linear operators over device tensors.

The reference writes everything against faer's ``LinOp`` / ``Precond``
trait objects (reference utils.rs:553-633, multigrid.rs:426-518).  Here
an operator is a small class holding tensors, with ``mv`` (matvec),
``mm`` (matmat on an (n, k) block), ``rmv``/``rmm`` (transpose) and
``__call__`` dispatching on the input's rank.  Symmetric operators keep
the default ``rmv = mv``.

Every sparse operator applies through the hand-written K1 + K2 kernels
(:mod:`tpu_amg_torch.ops.spmv`) from a capped CSR; small levels are
dense and apply with ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.spmv import CappedCSR, spmv
from tpu_amg_torch.sparse.csr import CSR


class LinearOperator:
    """Protocol: subclasses provide ``shape`` and ``mv``; get the rest."""

    shape: Tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def mv(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def mm(self, xs: torch.Tensor) -> torch.Tensor:
        """Matmat; default applies mv column by column."""
        return torch.stack([self.mv(xs[:, j]) for j in range(xs.shape[1])], 1)

    def rmv(self, x: torch.Tensor) -> torch.Tensor:
        """Transpose matvec. Default: the operator is symmetric."""
        return self.mv(x)

    def rmm(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.rmv(xs[:, j]) for j in range(xs.shape[1])], 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x) if x.dim() > 1 else self.mv(x)


@dataclasses.dataclass
class SparseOperator(LinearOperator):
    """Square or rectangular sparse operator: y = A x through K1 + K2.

    For operators used in both directions ``mat_t`` holds the
    materialized transpose, mirroring the reference, which materializes
    R = Pᵀ (interpolation/mod.rs:824-827)."""

    mat: CappedCSR
    mat_t: Optional[CappedCSR] = None
    block_size: int = 1

    @property
    def shape(self):
        return self.mat.shape

    def mv(self, x):
        return spmv(self.mat, x.contiguous())

    def mm(self, xs):
        return spmv(self.mat, xs.contiguous())

    def rmv(self, x):
        return spmv(self._transpose(), x.contiguous())

    def rmm(self, xs):
        return spmv(self._transpose(), xs.contiguous())

    def _transpose(self) -> CappedCSR:
        if self.mat_t is not None:
            return self.mat_t
        if self.shape[0] != self.shape[1]:
            raise ValueError("transpose apply of a rectangular operator "
                             "built without with_transpose")
        return self.mat

    @staticmethod
    def from_csr(csr: CSR, device, dtype=torch.float64,
                 with_transpose: bool = False):
        mat_t = None
        if with_transpose:
            mat_t = CappedCSR.from_csr(csr.transpose(), device, dtype)
        return SparseOperator(
            mat=CappedCSR.from_csr(csr, device, dtype),
            mat_t=mat_t,
            block_size=csr.block_size,
        )


@dataclasses.dataclass
class DenseOperator(LinearOperator):
    mat: torch.Tensor

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def mv(self, x):
        return self.mat @ x

    def mm(self, xs):
        return self.mat @ xs

    def rmv(self, x):
        return self.mat.T @ x

    def rmm(self, xs):
        return self.mat.T @ xs


@dataclasses.dataclass
class DiagonalOperator(LinearOperator):
    """diag(d): the diagonal smoothers' M⁻¹ (reference smoothers.rs:88-127)."""

    diag: torch.Tensor

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    def mv(self, x):
        return self.diag * x

    def mm(self, xs):
        return self.diag[:, None] * xs


@dataclasses.dataclass
class ScaledIdentity(LinearOperator):
    scale: float
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def mv(self, x):
        return self.scale * x

    def mm(self, xs):
        return self.scale * xs


def aslinearoperator(x, device, dtype=torch.float64) -> LinearOperator:
    """A host CSR becomes a :class:`SparseOperator`, a dense array a
    :class:`DenseOperator`; operators pass through."""
    if isinstance(x, LinearOperator):
        return x
    if isinstance(x, CSR):
        return SparseOperator.from_csr(x, device, dtype)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return DenseOperator(mat=to_device(x, device, dtype))
    raise TypeError(f"cannot convert {type(x)} to LinearOperator")
