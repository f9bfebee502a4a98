"""Linear operators over device tensors.

The reference writes everything against faer's ``LinOp`` / ``Precond``
trait objects (reference utils.rs:553-633, multigrid.rs:426-518).  Here
an operator is a small class holding tensors, with ``mv`` (matvec),
``mm`` (matmat on an (n, k) block), ``rmv``/``rmm`` (transpose) and
``__call__`` dispatching on the input's rank.  Symmetric operators keep
the default ``rmv = mv``.

A sparse operator applies through one of two hand-written kernel
routes, picked when it is built (:meth:`SparseOperator.from_csr`, the
JAX package's ``_pick_format`` rule 1): a DIA matrix through K3
(:mod:`tpu_amg_torch.ops.dia`) when the matrix is square, has few
distinct diagonals and fills them densely enough; otherwise a capped CSR
through K1 + K2 (:mod:`tpu_amg_torch.ops.spmv`).  Small levels are dense
and apply with ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.spmv import CappedCSR, spmv
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA, try_from_csr


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


def _apply(mat, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return mat.mm(x) if isinstance(mat, DIA) else spmv(mat, x)


@dataclasses.dataclass
class SparseOperator(LinearOperator):
    """Square or rectangular sparse operator: y = A x through K3 (DIA)
    or K1 + K2 (capped CSR).

    For operators used in both directions ``mat_t`` holds the
    materialized transpose, mirroring the reference, which materializes
    R = Pᵀ (interpolation/mod.rs:824-827).  Without it a square operator
    applies its transpose as itself (rmv = mv)."""

    mat: Union[CappedCSR, DIA]
    mat_t: Optional[Union[CappedCSR, DIA]] = None
    block_size: int = 1

    @property
    def shape(self):
        return self.mat.shape

    def mv(self, x):
        return _apply(self.mat, x)

    def mm(self, xs):
        return _apply(self.mat, xs)

    def rmv(self, x):
        return _apply(self._transpose(), x)

    def rmm(self, xs):
        return _apply(self._transpose(), xs)

    def _transpose(self):
        if self.mat_t is not None:
            return self.mat_t
        if self.shape[0] != self.shape[1]:
            raise ValueError("transpose apply of a rectangular operator "
                             "built without with_transpose")
        return self.mat

    @staticmethod
    def from_csr(csr: CSR, device, dtype=torch.float64,
                 with_transpose: bool = False,
                 dia_max_diags: int = 32, dia_max_density: float = 3.0):
        """DIA when the matrix is square with at most ``dia_max_diags``
        distinct diagonals, and n_diags · n ≤ ``dia_max_density`` · nnz
        (the JAX package's ``_pick_format`` rule 1,
        tpu_amg/linop.py:180-187); else a capped CSR.  The multigrid
        builders widen the envelope to 160 / 8.0 for Galerkin coarse
        operators."""

        def pick(m: CSR):
            if m.is_square:
                dia = try_from_csr(m, device, dtype, max_diags=dia_max_diags)
                if (dia is not None and len(dia.offsets) * m.nrows
                        <= dia_max_density * max(m.nnz, 1)):
                    return dia
            return CappedCSR.from_csr(m, device, dtype)

        return SparseOperator(
            mat=pick(csr),
            mat_t=pick(csr.transpose()) if with_transpose else None,
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
