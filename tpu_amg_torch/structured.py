"""Structured-grid multigrid: DIA levels and gather-free transfers.

Port of ``tpu_amg/structured.py``.  For a stencil operator on a tensor
grid every V-cycle ingredient needs no index stream:

- level operators: DIA stencils applied through K3
  (:mod:`tpu_amg_torch.sparse.dia`); a level that does not fit the wide
  DIA envelope (160 diagonals, density 8.0) is a capped CSR through
  K1 + K2, and levels at or under 4096 rows are dense;
- tentative transfers: factor-2 aggregation as repeat / reshape-sum
  (:class:`StructuredInterp`), with no indices;
- smoothed transfers P_s = (I − ω D⁻¹A) P_t applied lazily as a
  composition of P_t, the level's own operator and a diagonal scale
  (:class:`SmoothedTransferP`), without materializing the widened
  stencil;
- smoothers: Chebyshev (operator applies and AXPYs only); coarsest: a
  dense Cholesky inverse applied as a matmul.

The Galerkin coarse matrices are computed exactly on the host (SpGEMM
with the materialized smoothed P, reference interpolation/mod.rs:824-828),
so convergence is that of materialized smoothed aggregation; only the
application of P and R is restructured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import disable_tf32, resolve_device, to_device
from tpu_amg_torch.interpolation.sa import smooth_interpolation
from tpu_amg_torch.linop import DenseOperator, LinearOperator, SparseOperator
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg_torch.preconditioners.coarse import build_coarse_solver
from tpu_amg_torch.preconditioners.multigrid import Level, Multigrid
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ops import from_coo, spgemm

DENSE_ROWS = 4096  # levels at or under this many rows are dense


def structured_partition(grid_shape: Tuple[int, ...], factor: int = 2):
    """Factor-f aggregation of a tensor grid; returns (Partition,
    coarse_shape)."""
    coarse_shape = tuple((s + factor - 1) // factor for s in grid_shape)
    idx = np.indices(grid_shape)
    agg = np.zeros(grid_shape, dtype=np.int64)
    stride = 1
    for d in reversed(range(len(grid_shape))):
        agg += (idx[d] // factor) * stride
        stride *= coarse_shape[d]
    return Partition(agg.reshape(-1)), coarse_shape


@dataclasses.dataclass
class StructuredInterp(LinearOperator):
    """Tentative P for factor-f tensor aggregation: ``mv`` repeats the
    coarse grid f times along each axis, cuts it to the fine shape and
    scales by ``weights``; ``rmv`` weights, zero-pads each axis to
    coarse · f and sums each run of f.  ``weights`` are the per-fine-node
    tentative-P entries (1/√|agg| for the constant candidate)."""

    weights: torch.Tensor  # (n_fine,)
    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    factor: int = 2

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))

    def _up(self, xc: torch.Tensor) -> torch.Tensor:
        """(n_coarse, k) → (n_fine, k), unweighted."""
        up = xc.reshape(self.coarse_shape + (xc.shape[1],))
        for d, fs in enumerate(self.fine_shape):
            # repeat each entry `factor` times along axis d (as
            # jnp.repeat), by broadcasting: no host sync, graph-safe
            shape = up.shape
            up = up.unsqueeze(d + 1).expand(
                shape[:d + 1] + (self.factor,) + shape[d + 1:]
            ).reshape(shape[:d] + (shape[d] * self.factor,) + shape[d + 1:])
            if up.shape[d] != fs:
                up = up.narrow(d, 0, fs)
        return up.reshape(-1, xc.shape[1])

    def _down(self, w: torch.Tensor) -> torch.Tensor:
        """(n_fine, k), already weighted → (n_coarse, k)."""
        k = w.shape[1]
        w = w.reshape(self.fine_shape + (k,))
        for d, (fs, cs) in enumerate(zip(self.fine_shape, self.coarse_shape)):
            pad_to = cs * self.factor
            if pad_to != fs:
                pad = list(w.shape)
                pad[d] = pad_to - fs
                w = torch.cat([w, w.new_zeros(pad)], dim=d)
            w = w.reshape(w.shape[:d] + (cs, self.factor) + w.shape[d + 1:])
            w = w.sum(d + 1)
        return w.reshape(-1, k)

    def mv(self, xc):
        return self.weights * self._up(xc[:, None])[:, 0]

    def mm(self, xs):
        return self.weights[:, None] * self._up(xs)

    def rmv(self, xf):
        return self._down((self.weights * xf)[:, None])[:, 0]

    def rmm(self, xs):
        return self._down(self.weights[:, None] * xs)

    def to_csr(self) -> CSR:
        """The materialized P on the host, for the Galerkin products."""
        part, _ = structured_partition(self.fine_shape, self.factor)
        n_f = self.shape[0]
        return from_coo(
            np.arange(n_f), part.node_to_agg,
            self.weights.cpu().numpy(), (n_f, part.num_aggs),
        )


@dataclasses.dataclass
class SmoothedTransferP(LinearOperator):
    """P_s = (I − ω D⁻¹ A) P_t, applied lazily through the level's
    operator A (no widened stencil).  ``d_inv`` is ω·D⁻¹."""

    tentative: StructuredInterp
    a: LinearOperator
    d_inv: torch.Tensor

    @property
    def shape(self):
        return self.tentative.shape

    def mv(self, xc):
        px = self.tentative.mv(xc)
        return px - self.d_inv * self.a.mv(px)

    def rmv(self, xf):
        # P_sᵀ = P_tᵀ (I − A D⁻¹ω)  (A symmetric)
        return self.tentative.rmv(xf - self.a.mv(self.d_inv * xf))

    def mm(self, xs):
        px = self.tentative.mm(xs)
        return px - self.d_inv[:, None] * self.a.mm(px)

    def rmm(self, xs):
        return self.tentative.rmm(xs - self.a.mm(self.d_inv[:, None] * xs))


@dataclasses.dataclass
class TransposeOp(LinearOperator):
    inner: LinearOperator

    @property
    def shape(self):
        return (self.inner.shape[1], self.inner.shape[0])

    def mv(self, x):
        return self.inner.rmv(x)

    def mm(self, xs):
        return self.inner.rmm(xs)

    def rmv(self, x):
        return self.inner.mv(x)

    def rmm(self, xs):
        return self.inner.mm(xs)


def build_structured_multigrid(
    a: CSR,
    grid_shape: Tuple[int, ...],
    *,
    device,
    coarsest_dim: int = 1000,
    smoothing: bool = True,
    jacobi_weight: float = 0.66,
    chebyshev_degree: int = 3,
    dtype: torch.dtype = torch.float32,
    lambda_starts: Optional[Sequence[np.ndarray]] = None,
) -> Multigrid:
    """Smoothed-aggregation V-cycle for a stencil operator on a tensor
    grid, on ``device``: factor-2 aggregation while a level has more
    than ``coarsest_dim`` rows and every axis at least 4 points, then a
    dense Cholesky coarse solve.  ``lambda_starts[l]``, when given, is
    the start vector of level l's Chebyshev λ_max power iteration."""
    device = resolve_device(device)
    disable_tf32()  # the dense float32 levels must not run in TF32
    levels = []
    cur, cur_shape = a, tuple(grid_shape)
    while cur.nrows > coarsest_dim and min(cur_shape) >= 4:
        part, coarse_shape = structured_partition(cur_shape)
        sizes = part.agg_sizes()
        weights = 1.0 / np.sqrt(sizes[part.node_to_agg].astype(np.float64))
        if cur.nrows <= DENSE_ROWS:
            a_op: LinearOperator = DenseOperator(
                mat=to_device(cur.to_dense(), device, dtype)
            )
        else:
            # Galerkin stencils widen to ~125 diagonals on coarse levels
            a_op = SparseOperator.from_csr(
                cur, device, dtype, dia_max_diags=160, dia_max_density=8.0
            )
        tent = StructuredInterp(
            weights=to_device(weights, device, dtype),
            fine_shape=cur_shape, coarse_shape=coarse_shape,
        )
        p_csr = tent.to_csr()
        p_dev: LinearOperator = tent
        if smoothing:
            p_dev = SmoothedTransferP(
                tentative=tent, a=a_op,
                d_inv=to_device(jacobi_weight / cur.diagonal(), device, dtype),
            )
            p_csr = smooth_interpolation(cur, p_csr, jacobi_weight)
        coarse = spgemm(p_csr.transpose(), spgemm(cur, p_csr))
        smoother = ChebyshevSmoother.build(
            a_op, to_device(1.0 / cur.abs_row_sums(), device, dtype),
            degree=chebyshev_degree,
            v0=None if lambda_starts is None else lambda_starts[len(levels)],
        )
        levels.append(
            Level(a=a_op, smoother=smoother, r=TransposeOp(inner=p_dev), p=p_dev)
        )
        cur, cur_shape = coarse, coarse_shape
    return Multigrid(
        levels=tuple(levels),
        coarse_solver=build_coarse_solver("cholesky", cur, device, dtype),
        mu=1,
        smoothing_steps=1,
    )
