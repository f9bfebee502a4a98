"""Diagonal smoothers and k-step relaxation operators.

Mirrors reference src/preconditioners/smoothers.rs, with the formulas
preserved exactly (SURVEY.md Appendix A), computed from the host CSR:

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
from tpu_amg_torch.linop import DiagonalOperator, LinearOperator
from tpu_amg_torch.sparse.csr import CSR


def l1_inverse_diag(a: CSR) -> np.ndarray:
    """1 / Σⱼ|aᵢⱼ| (reference new_l1, smoothers.rs:63-76)."""
    return 1.0 / a.abs_row_sums()


def l2_inverse_diag(a: CSR) -> np.ndarray:
    """1 / Σⱼ(|aᵢⱼ|·√(aᵢᵢ)/√(aⱼⱼ)) (reference new_l2, smoothers.rs:43-61)."""
    d = np.sqrt(a.diagonal())
    rows, cols, vals = a.coo()
    acc = np.zeros(a.nrows)
    np.add.at(acc, rows, np.abs(vals) * d[rows] / d[cols])
    return 1.0 / acc


def jacobi_inverse_diag(a: CSR, omega: float = 1.0) -> np.ndarray:
    """ω / aᵢᵢ (reference new_jacobi, smoothers.rs:78-86)."""
    return omega / a.diagonal()


def build_smoother(kind: str, a: CSR, device, dtype=torch.float64,
                   omega: float = 1.0) -> DiagonalOperator:
    """Reference ``SmootherKind::build`` (smoothers.rs:23-33);
    kind in {"l1", "l2", "jacobi"}."""
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
