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
through K1 + K2 (:mod:`tpu_amg_torch.ops.spmv`).  An operator built
over an :class:`~tpu_amg_torch.sparse.ell.ELL` or a
:class:`~tpu_amg_torch.sparse.bsr.BSR` applies through K1 + K2 too, on
the capped CSR that the container carries.  Small levels are dense and
apply with ``torch.matmul``.

An operator's arrays may be narrower than the vectors it is applied to
(a cycle cast by :mod:`tpu_amg_torch.precision`).  Every apply then
computes and returns in ``torch.promote_types`` of the two, as the JAX
formats do (``jnp.result_type``): the sparse kernels widen their values
per entry, ``torch.matmul`` a dense matrix per apply (:func:`matmul`),
and a scalar's dtype takes part as a JAX array's does (:func:`scale`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.ops.spmv import CappedCSR, spmv
from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA, try_from_csr
from tpu_amg_torch.sparse.ell import ELL


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
    """y = mat x through K3 (DIA) or K1 + K2 (capped CSR, or the capped
    CSR of an ELL or a BSR), in the promotion of the values' and x's
    dtypes: x is widened where the values are wider.  Where both are
    bf16 the apply is the f32 island (:mod:`tpu_amg_torch.precision`): x
    widened to f32, the (bf16, f32) kernels, y rounded to bf16 once."""
    out = torch.promote_types(mat.dtype, x.dtype)
    if out == torch.bfloat16:
        return _apply(mat, x.to(torch.float32)).to(out)
    x = x.to(out).contiguous()
    if isinstance(mat, DIA):
        return mat.mm(x)
    return spmv(mat.capped if isinstance(mat, (ELL, BSR)) else mat, x)


def matmul(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mat @ x`` in the promotion of their dtypes, the narrower widened
    for this apply only (``torch.matmul`` takes one dtype; XLA converts
    ``jnp.dot(bf16, f64)`` the same way).  No wide copy is kept."""
    dt = torch.promote_types(mat.dtype, x.dtype)
    return mat.to(dt) @ x.to(dt)


def scale(s, x: torch.Tensor) -> torch.Tensor:
    """``s * x`` for a Python-float or 0-d tensor ``s``, in the dtype a
    JAX array scalar gives: a 0-d tensor's dtype takes part in the
    promotion (torch's own rule would keep x's)."""
    if isinstance(s, torch.Tensor):
        x = x.to(torch.promote_types(s.dtype, x.dtype))
    return s * x


@dataclasses.dataclass
class SparseOperator(LinearOperator):
    """Square or rectangular sparse operator: y = A x through K3 (DIA)
    or K1 + K2 (capped CSR, ELL or BSR).

    For operators used in both directions ``mat_t`` holds the
    materialized transpose, mirroring the reference, which materializes
    R = Pᵀ (interpolation/mod.rs:824-827).  Without it a square operator
    applies its transpose as itself (rmv = mv)."""

    mat: Union[CappedCSR, DIA, ELL, BSR]
    mat_t: Optional[Union[CappedCSR, DIA, ELL, BSR]] = None
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
                 with_transpose: bool = False, prefer_dia: bool = True,
                 dia_max_diags: int = 32, dia_max_density: float = 3.0):
        """DIA when ``prefer_dia``, the matrix is square with at most
        ``dia_max_diags`` distinct diagonals, and n_diags · n ≤
        ``dia_max_density`` · nnz (the JAX package's ``_pick_format``
        rule 1, tpu_amg/linop.py:180-187); else a capped CSR.  The
        multigrid builders widen the envelope to 160 / 8.0 for Galerkin
        coarse operators."""

        def pick(m: CSR):
            if prefer_dia and m.is_square:
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
        return matmul(self.mat, x)

    def mm(self, xs):
        return matmul(self.mat, xs)

    def rmv(self, x):
        return matmul(self.mat.T, x)

    def rmm(self, xs):
        return matmul(self.mat.T, xs)


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
    """scale · I; ``scale`` a float, or a 0-d tensor after a precision
    cast (the JAX package keeps an array)."""

    scale: Union[float, torch.Tensor]
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def mv(self, x):
        return scale(self.scale, x)

    def mm(self, xs):
        return scale(self.scale, xs)


@dataclasses.dataclass
class TransposeOperator(LinearOperator):
    """Aᵀ as a view of an operator: mv is the base's rmv, rmv its mv
    (the JAX package's ``TransposeOperator``, tpu_amg/linop.py:395-422)."""

    base: LinearOperator

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def block_size(self) -> int:
        return getattr(self.base, "block_size", 1)

    def mv(self, x):
        return self.base.rmv(x)

    def mm(self, xs):
        return self.base.rmm(xs)

    def rmv(self, x):
        return self.base.mv(x)

    def rmm(self, xs):
        return self.base.mm(xs)


@dataclasses.dataclass(frozen=True)
class ComposedOperator(LinearOperator):
    """B ∘ A: y = B(A(x)). rmv = Aᵀ Bᵀ."""

    a: LinearOperator
    b: LinearOperator

    @property
    def shape(self):
        return (self.b.shape[0], self.a.shape[1])

    def mv(self, x):
        return self.b.mv(self.a.mv(x))

    def mm(self, xs):
        return self.b.mm(self.a.mm(xs))

    def rmv(self, x):
        return self.a.rmv(self.b.rmv(x))

    def rmm(self, xs):
        return self.a.rmm(self.b.rmm(xs))


def aslinearoperator(x, device, dtype=torch.float64) -> LinearOperator:
    """A host CSR becomes a :class:`SparseOperator`, a dense array a
    :class:`DenseOperator`; an ELL or a BSR is wrapped as it is;
    operators pass through."""
    if isinstance(x, LinearOperator):
        return x
    if isinstance(x, (ELL, BSR)):
        return SparseOperator(mat=x, block_size=x.block_size)
    if isinstance(x, CSR):
        return SparseOperator.from_csr(x, device, dtype)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return DenseOperator(mat=to_device(x, device, dtype))
    raise TypeError(f"cannot convert {type(x)} to LinearOperator")
