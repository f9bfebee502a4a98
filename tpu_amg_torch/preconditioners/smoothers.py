"""Diagonal smoothers and k-step relaxation operators.

Mirrors reference src/preconditioners/smoothers.rs, with the formulas
preserved exactly (SURVEY.md Appendix A), computed from a host CSR (in
numpy) or, as the JAX package computes them, from a device ELL or BSR
or a ``SparseOperator`` over one (in torch, on its device):

- l1:     dᵢ = Σⱼ |aᵢⱼ|,                        M = diag(1/d)   (smoothers.rs:63-76)
- l2:     dᵢ = Σⱼ |aᵢⱼ|·√(aᵢᵢ)/√(aⱼⱼ),          M = diag(1/d)   (smoothers.rs:43-61)
- jacobi: M = diag(ω/aᵢᵢ)                                        (smoothers.rs:78-86)

``KStepSmoother`` is the corrected Richardson analog of the reference's
``StationaryIteration`` (smoothers.rs:129-171 — whose apply substitutes x
for b after the first sweep; see SURVEY.md Appendix B).  ``ErrorPropagator``
is the reference's adaptivity.rs:168-241 operator E = (I − M A)ᵏ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.linop import DiagonalOperator, LinearOperator, SparseOperator
from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ell import ELL


def _as_matrix(a):
    """A CSR, ELL or BSR; a ``SparseOperator`` over an ELL or a BSR gives
    its matrix (the JAX package's ``_as_matrix``)."""
    if isinstance(a, SparseOperator):
        a = a.mat
    if isinstance(a, (CSR, ELL, BSR)):
        return a
    raise TypeError(f"expected a CSR, ELL or BSR, or a SparseOperator over "
                    f"an ELL or a BSR; got {type(a).__name__}"
                    + (f" over {type(a.mat).__name__}"
                       if isinstance(a, SparseOperator) else ""))


def l1_inverse_diag(a):
    """1 / Σⱼ|aᵢⱼ| (reference new_l1, smoothers.rs:63-76)."""
    return 1.0 / _as_matrix(a).abs_row_sums()


def l2_inverse_diag(a):
    """1 / Σⱼ(|aᵢⱼ|·√(aᵢᵢ)/√(aⱼⱼ)) (reference new_l2, smoothers.rs:43-61)."""
    mat = _as_matrix(a)
    if isinstance(mat, CSR):
        d = np.sqrt(mat.diagonal())
        rows, cols, vals = mat.coo()
        acc = np.zeros(mat.nrows)
        np.add.at(acc, rows, np.abs(vals) * d[rows] / d[cols])
        return 1.0 / acc
    d = torch.sqrt(mat.diagonal())
    if isinstance(mat, ELL):  # padded slots: a zero value at column 0
        return 1.0 / (mat.data.abs() * (d[:, None]
                                        / d[mat.cols.long()])).sum(1)
    db = d.view(-1, mat.block_size)  # (block rows, bs)
    scale = db[:, None, :, None] / db[mat.cols.long()][:, :, None, :]
    return 1.0 / (mat.data.abs() * scale).sum((1, 3)).reshape(-1)


def jacobi_inverse_diag(a, omega: float = 1.0):
    """ω / aᵢᵢ (reference new_jacobi, smoothers.rs:78-86)."""
    return omega / _as_matrix(a).diagonal()


def build_smoother(kind: str, a, device, dtype=torch.float64,
                   omega: float = 1.0) -> DiagonalOperator:
    """Reference ``SmootherKind::build`` (smoothers.rs:23-33);
    kind in {"l1", "l2", "jacobi"}; ``a`` as :func:`_as_matrix` takes
    it."""
    if kind == "l1":
        d = l1_inverse_diag(a)
    elif kind == "l2":
        d = l2_inverse_diag(a)
    elif kind == "jacobi":
        d = jacobi_inverse_diag(a, omega)
    else:
        raise ValueError(f"unknown smoother kind {kind!r}")
    return DiagonalOperator(diag=to_device(d, device, dtype))


@dataclasses.dataclass
class KStepSmoother(LinearOperator):
    """k-step preconditioned Richardson from zero initial guess, as an
    operator: x = Σ_{j<k} M (I − A M)ʲ b.  Symmetric when A and M are."""

    a: LinearOperator
    m: LinearOperator
    iters: int

    @property
    def shape(self):
        return self.a.shape

    def _run(self, b):
        x = self.m(b)
        for _ in range(self.iters - 1):
            x = x + self.m(b - self.a(x))
        return x

    def mv(self, x):
        return self._run(x)

    def mm(self, xs):
        return self._run(xs)


@dataclasses.dataclass
class ErrorPropagator(LinearOperator):
    """E = (I − M A)ᵏ; rmv applies Eᵀ = (I − A M)ᵏ.

    Reference ``ErrorPropogator`` (adaptivity.rs:168-241): the operator
    whose dominant invariant subspace is the near-null space that
    adaptive AMG hunts for.
    """

    a: LinearOperator
    m: LinearOperator
    iters: int = 1

    @property
    def shape(self):
        return self.a.shape

    def _fwd(self, x):
        for _ in range(self.iters):
            x = x - self.m(self.a(x))
        return x

    def _bwd(self, x):
        for _ in range(self.iters):
            x = x - self.a(self.m(x))
        return x

    def mv(self, x):
        return self._fwd(x)

    def mm(self, xs):
        return self._fwd(xs)

    def rmv(self, x):
        return self._bwd(x)

    def rmm(self, xs):
        return self._bwd(xs)
