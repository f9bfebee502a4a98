"""Coarsest-level direct solvers.

The reference offers sparse/dense Cholesky (``CoarseSolverKind::Cholesky``)
with SVD/Eigh declared but unimplemented (reference coarse_solvers.rs:27-40).
The coarsest grid is small, so it is densified and its inverse is
materialized once at build, on the host, through the Cholesky factor:
every application is then one dense matmul on the device.  The
pseudo-inverse (eigh) variant the reference stubs out serves
semi-definite coarse grids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.sparse.csr import CSR

DENSE_COARSE_CAP = 20_000


def _densify(a) -> np.ndarray:
    if isinstance(a, CSR):
        return a.to_dense()
    return np.asarray(a, dtype=np.float64)


@dataclasses.dataclass
class DenseCholeskySolver(LinearOperator):
    """Exact solve via a Cholesky-factored inverse, applied as a dense
    matmul (role of the reference's Dense/SparseCholeskySolve,
    coarse_solvers.rs:55-276).  Symmetric: rmv = mv."""

    inv: torch.Tensor  # A⁻¹ = L⁻ᵀ L⁻¹, materialized at build

    @property
    def shape(self):
        return tuple(self.inv.shape)

    @staticmethod
    def build(a, device, dtype=torch.float64) -> "DenseCholeskySolver":
        chol = np.linalg.cholesky(_densify(a))
        inv_l = np.linalg.inv(chol)
        return DenseCholeskySolver(
            inv=to_device(inv_l.T @ inv_l, device, dtype)
        )

    def mv(self, x):
        return self.inv @ x

    def mm(self, xs):
        return self.inv @ xs


@dataclasses.dataclass
class DensePinvSolver(LinearOperator):
    """Pseudo-inverse solve via eigendecomposition (the reference's
    unimplemented ``CoarseSolverKind::Eigh``, coarse_solvers.rs:27-40).

    Robust for singular/semi-definite coarse operators (e.g. pure-Neumann
    problems where the constant is in the kernel).
    """

    pinv: torch.Tensor  # materialized dense pseudo-inverse

    @property
    def shape(self):
        return tuple(self.pinv.shape)

    @staticmethod
    def build(a, device, dtype=torch.float64,
              rtol: float = 1e-12) -> "DensePinvSolver":
        w, v = np.linalg.eigh(_densify(a))
        cutoff = rtol * np.max(np.abs(w))
        inv_w = np.where(np.abs(w) > cutoff, 1.0 / w, 0.0)
        return DensePinvSolver(
            pinv=to_device((v * inv_w) @ v.T, device, dtype)
        )

    def mv(self, x):
        return self.pinv @ x

    def mm(self, xs):
        return self.pinv @ xs


def build_coarse_solver(kind: str, a, device,
                        dtype=torch.float64) -> LinearOperator:
    """Reference ``CoarseSolverKind`` dispatch (coarse_solvers.rs:14-42):
    "cholesky", or "eigh"/"pinv"/"svd" for the pseudo-inverse.  Coarsest
    levels above ``DENSE_COARSE_CAP`` dofs need the banded sparse
    factorization, which is not ported yet."""
    n = a.shape[0]
    if n > DENSE_COARSE_CAP:
        raise NotImplementedError(
            f"coarsest level has {n} dofs; dense solves stop at "
            f"{DENSE_COARSE_CAP} (lower coarsest_dim or lift max_levels)"
        )
    if kind == "cholesky":
        return DenseCholeskySolver.build(a, device, dtype)
    if kind in ("eigh", "pinv", "svd"):
        return DensePinvSolver.build(a, device, dtype)
    raise ValueError(f"unknown coarse solver kind {kind!r}")
