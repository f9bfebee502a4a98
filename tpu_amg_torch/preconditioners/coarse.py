"""Coarsest-level direct solvers.

The reference offers sparse/dense Cholesky (``CoarseSolverKind::Cholesky``)
with SVD/Eigh declared but unimplemented (reference coarse_solvers.rs:27-40).
A small coarsest grid is densified and its inverse is materialized once
at build, on the host, through the Cholesky factor: every application
is then one dense matmul on the device.  The pseudo-inverse (eigh)
variant the reference stubs out serves semi-definite coarse grids.  A
coarsest grid past ``DENSE_COARSE_CAP`` dofs (a two-level classical
hierarchy's) takes the banded Cholesky factorization instead
(:class:`BandedCholeskySolver`).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.errors import MultigridBuildError
from tpu_amg_torch.linop import LinearOperator, SparseOperator, matmul
from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ell import ELL

logger = logging.getLogger(__name__)

DENSE_COARSE_CAP = 20_000


def _densify(a) -> np.ndarray:
    """A CSR, an ELL or a BSR (or a ``SparseOperator`` over one of
    those), or a dense array, as a dense float64 array on the host."""
    if isinstance(a, SparseOperator) and isinstance(a.mat, (ELL, BSR)):
        a = a.mat
    if isinstance(a, CSR):
        return a.to_dense()
    if isinstance(a, (ELL, BSR)):
        dense = np.zeros(a.shape)
        data = a.data.detach().cpu().to(torch.float64).numpy()
        cols = a.cols.cpu().numpy().astype(np.int64)
        if isinstance(a, ELL):  # padded slots add 0 at column 0
            rows = np.arange(a.nrows)[:, None]
        else:  # padded blocks add 0 at block column 0
            bs = a.block_size
            rows = (np.arange(a.nrows // bs)[:, None, None, None] * bs
                    + np.arange(bs)[None, None, :, None])
            cols = cols[:, :, None, None] * bs + np.arange(bs)
        np.add.at(dense, (rows, cols), data)
        return dense
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
        return matmul(self.inv, x)

    def mm(self, xs):
        return matmul(self.inv, xs)


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
        return matmul(self.pinv, x)

    def mm(self, xs):
        return matmul(self.pinv, xs)


@dataclasses.dataclass
class BandedCholeskySolver(LinearOperator):
    """Sparse direct solve for large coarsest levels: the port of the JAX
    package's banded solver (tpu_amg/preconditioners/coarse.py:116-294),
    in the role of the reference's sparse LLT (coarse_solvers.rs:166-276).

    Setup (host, one-time): RCM-reorder the coarse operator to a small
    bandwidth b, factor it with a banded Cholesky (LAPACK pbtrf through
    scipy; the band is the exact fill pattern of the factor), then slice
    L into an s×s block-bidiagonal form with s ≥ b and materialize the
    diagonal blocks' inverses.

    Apply (device): two substitution sweeps over the nb blocks, each step
    two dense (s, s)·(s, k) products (``torch.addmm``, which folds in the
    subtraction, then ``torch.matmul``):
    forward  u_i = L_ii⁻¹ (x_i − L_{i,i−1} u_{i−1}) and
    backward z_i = L_ii⁻ᵀ (u_i − L_{i+1,i}ᵀ z_{i+1}).
    The loop's length and every shape are fixed at build, so the apply
    has no host sync and no data-dependent allocation: a CUDA graph
    captures it.  It reads inv_l_diag and sub once a sweep.
    """

    inv_l_diag: torch.Tensor  # (nb, s, s) L_ii⁻¹
    sub: torch.Tensor  # (nb, s, s) L_{i,i−1} (block 0 is zero)
    perm: torch.Tensor  # RCM permutation (int64)
    iperm: torch.Tensor  # inverse permutation
    n: int
    bandwidth: int  # b, the RCM-ordered matrix's (and L's) half-bandwidth

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def build(
        a,
        device,
        dtype=torch.float64,
        max_bandwidth: int = 4096,
        max_factor_flops: float = 5e11,
        max_device_bytes: int = 2 << 30,
    ) -> "BandedCholeskySolver":
        """Factor ``a`` (a CSR, or a dense array) on the host and place
        the blocks on ``device`` in ``dtype``.  Raises
        :class:`MultigridBuildError` past a budget: RCM bandwidth over
        ``max_bandwidth``, n·b² over ``max_factor_flops``, or the two
        (nb, s, s) stacks over ``max_device_bytes`` in ``dtype``; and
        when the factorization fails (``a`` not SPD)."""
        import scipy.linalg as sla
        import scipy.sparse as sps

        from tpu_amg_torch.utils.reorder import rcm_permutation

        t0 = time.perf_counter()
        csr = a if isinstance(a, CSR) else CSR.from_dense(_densify(a))
        sp = csr.to_scipy().tocsr()
        sp.sort_indices()
        n = sp.shape[0]

        perm = rcm_permutation(csr)
        spp = sp[perm][:, perm].tocoo()
        b = int(np.abs(spp.row - spp.col).max()) if spp.nnz else 0
        if b > max_bandwidth:
            raise MultigridBuildError(
                f"coarse level ({n} dofs) has RCM bandwidth {b} > "
                f"{max_bandwidth}; banded Cholesky would be denser than "
                "useful — coarsen further or raise max_bandwidth."
            )
        if n * float(b) ** 2 > max_factor_flops:
            raise MultigridBuildError(
                f"banded factorization cost n*b^2 = {n * b * b:.2e} flops "
                "exceeds the setup budget."
            )
        s = max(128, -(-max(b, 1) // 128) * 128)
        nb = -(-n // s)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if 2 * nb * s * s * itemsize > max_device_bytes:
            raise MultigridBuildError(
                f"banded factor blocks need {2 * nb * s * s * itemsize:.2e}"
                " bytes on device — over budget."
            )

        # lower band form ab[i, j] = B[j+i, j], i = 0..b
        sppc = spp.tocsr()
        rows = np.repeat(np.arange(n), np.diff(sppc.indptr))
        cols = sppc.indices
        lower = rows >= cols
        ab = np.zeros((b + 1, n))
        ab[rows[lower] - cols[lower], cols[lower]] = sppc.data[lower]
        t1 = time.perf_counter()
        try:
            cb = sla.cholesky_banded(ab, lower=True)
        except (np.linalg.LinAlgError, ValueError) as e:
            raise MultigridBuildError(
                f"banded Cholesky failed (operator not SPD?): {e}"
            ) from e
        t2 = time.perf_counter()

        # L as scipy sparse for block slicing; tail rows padded with 1.0
        npad = nb * s
        li, lj, lv = [], [], []
        for d in range(b + 1):
            j = np.arange(n - d)
            v = cb[d, j]
            nzm = v != 0.0
            li.append(j[nzm] + d)
            lj.append(j[nzm])
            lv.append(v[nzm])
        if npad > n:
            pad = np.arange(n, npad)
            li.append(pad)
            lj.append(pad)
            lv.append(np.ones(npad - n))
        lmat = sps.coo_matrix(
            (np.concatenate(lv), (np.concatenate(li), np.concatenate(lj))),
            shape=(npad, npad),
        ).tocsr()

        inv_l_diag = np.zeros((nb, s, s))
        sub = np.zeros((nb, s, s))
        eye = np.eye(s)
        for i in range(nb):
            sl = slice(i * s, (i + 1) * s)
            lii = lmat[sl, sl].toarray()
            inv_l_diag[i] = sla.solve_triangular(lii, eye, lower=True)
            if i:
                sub[i] = lmat[sl, slice((i - 1) * s, i * s)].toarray()
        logger.info(
            "banded Cholesky of n=%d: RCM bandwidth %d, s=%d, nb=%d; RCM "
            "and band %.2fs, factor (pbtrf) %.2fs, blocks and L_ii^-1 %.2fs",
            n, b, s, nb, t1 - t0, t2 - t1, time.perf_counter() - t2,
        )
        return BandedCholeskySolver(
            inv_l_diag=to_device(inv_l_diag, device, dtype),
            sub=to_device(sub, device, dtype),
            perm=to_device(perm, device, torch.int64),
            iperm=to_device(np.argsort(perm), device, torch.int64),
            n=int(n),
            bandwidth=b,
        )

    def device_bytes(self) -> int:
        """Bytes of the two (nb, s, s) stacks: what each sweep reads."""
        return 2 * self.inv_l_diag.numel() * self.inv_l_diag.element_size()

    def _solve_blocks(self, xb: torch.Tensor) -> torch.Tensor:
        """xb: (nb, s, k) permuted + padded rhs blocks → solution blocks.
        A narrower stack (a precision cast) is widened for this apply."""
        invd = self.inv_l_diag.to(xb.dtype)
        sub = self.sub.to(xb.dtype)
        nb = xb.shape[0]
        # forward: block 0 has no L_{0,-1}; each later step is one fused
        # x_i − L_{i,i−1} u_{i−1} (addmm) and one product with L_ii⁻¹
        u = [invd[0] @ xb[0]]
        for i in range(1, nb):
            u.append(invd[i] @ torch.addmm(xb[i], sub[i], u[-1], alpha=-1))
        # backward: block nb − 1 has no L_{nb,nb−1}
        z = [None] * nb
        z[-1] = invd[-1].T @ u[-1]
        for i in range(nb - 2, -1, -1):
            z[i] = invd[i].T @ torch.addmm(u[i], sub[i + 1].T, z[i + 1],
                                           alpha=-1)
        return torch.stack(z)

    def mm(self, xs):
        squeeze = xs.dim() == 1
        if squeeze:
            xs = xs[:, None]
        nb, s, _ = self.inv_l_diag.shape
        dt = torch.promote_types(self.inv_l_diag.dtype, xs.dtype)
        xp = torch.zeros((nb * s, xs.shape[1]), dtype=dt, device=xs.device)
        xp[: self.n] = xs[self.perm]
        z = self._solve_blocks(xp.reshape(nb, s, -1))
        y = z.reshape(nb * s, -1)[: self.n][self.iperm]
        return y[:, 0] if squeeze else y

    def mv(self, x):
        return self.mm(x)


def build_coarse_solver(kind: str, a, device,
                        dtype=torch.float64) -> LinearOperator:
    """Reference ``CoarseSolverKind`` dispatch (coarse_solvers.rs:14-42),
    as the JAX package's (tpu_amg/preconditioners/coarse.py:298-331).

    ``cholesky`` picks dense (materialized inverse, one matmul per apply)
    at or below ``DENSE_COARSE_CAP`` dofs and the banded sparse
    factorization above it — the role split of the reference's
    Dense/SparseCholeskySolve (coarse_solvers.rs:55-162 vs :166-276);
    ``banded`` / ``banded_cholesky`` asks for the banded one at any size;
    ``eigh`` / ``pinv`` / ``svd`` give the dense pseudo-inverse."""
    n = a.shape[0]
    if kind in ("banded", "banded_cholesky") or (
        kind == "cholesky" and n > DENSE_COARSE_CAP
    ):
        # n^2 densification at this size is multi-GB: use the sparse
        # banded factorization instead
        return BandedCholeskySolver.build(a, device, dtype)
    if n > DENSE_COARSE_CAP:
        raise MultigridBuildError(
            f"coarsest level has {n} dofs — too large for a dense "
            f"{kind} solve. Use kind='cholesky' (auto-banded), lower "
            "max_levels restrictions, or raise coarsest_dim."
        )
    if kind == "cholesky":
        return DenseCholeskySolver.build(a, device, dtype)
    if kind in ("eigh", "pinv", "svd"):
        return DensePinvSolver.build(a, device, dtype)
    raise ValueError(f"unknown coarse solver kind {kind!r}")
