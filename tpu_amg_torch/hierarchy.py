"""Multigrid hierarchy construction (setup).

Reference ``HierarchyConfig``/``Hierarchy`` (hierarchy.rs): the level loop
builds a Galerkin coarsening (partition → P/R → RAP) from the current
operator + near-null basis, post-processes the coarse near-null with 3
steps of l1-Jacobi error-propagation smoothing followed by a thin-QR
re-orthonormalization (hierarchy.rs:219-228; the reference routes this
through its StationaryIteration whose ``apply`` has a known bug — SURVEY.md
Appendix B — the intended v ← (I − M A)v relaxation is implemented), and
repeats while dim > coarsest_dim (default 1000) up to max_levels.

Near-null *weights* are recomputed per level as wₖ = 1/(vₖᵀAvₖ) (the
reference only stores level-0 weights, hierarchy.rs:341-344).

The partition, P, R and RAP are host work; the error-propagation steps
of the near-null post-process run on ``device`` in float64 through the
sparse kernels.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from tpu_amg_torch.device import resolve_device, to_device
from tpu_amg_torch.interpolation import InterpolationConfig
from tpu_amg_torch.interpolation.sa import GalerkinCoarse, filter_matrix
from tpu_amg_torch.linop import DiagonalOperator, SparseOperator
from tpu_amg_torch.partition import Partition
from tpu_amg_torch.preconditioners.smoothers import (
    ErrorPropagator,
    l1_inverse_diag,
)
from tpu_amg_torch.sparse import CSR

logger = logging.getLogger(__name__)


def create_weights(a: CSR, near_null: np.ndarray) -> np.ndarray:
    """wₖ = 1/(vₖᵀAvₖ) (reference create_weights, adaptivity.rs:434-443)."""
    av = a.matvec(near_null)
    return 1.0 / np.einsum("nk,nk->k", near_null, av)


@dataclasses.dataclass
class HierarchyConfig:
    """Defaults: coarsest_dim 1000, no level cap (hierarchy.rs:28-36)."""

    coarsest_dim: int = 1000
    interpolation_config: InterpolationConfig = dataclasses.field(
        default_factory=InterpolationConfig
    )
    max_levels: Optional[int] = None
    # Non-Galerkin coarse-operator sparsification (Treister/Yavneh
    # class): after each RAP, drop |a_ij| < tol*sqrt(a_ii*a_jj) and lump
    # |a_ij| of the dropped entries into the diagonal
    # (interpolation/sa.py filter_matrix with lump_abs=True, which keeps
    # the coarse operator SPD).
    coarse_drop_tol: Optional[float] = None
    device: str = "cuda"  # where the near-null post-process runs

    def build(
        self, a: CSR, near_null: np.ndarray, nn_weights: Optional[np.ndarray] = None
    ) -> "Hierarchy":
        near_null = np.asarray(near_null, dtype=np.float64)
        if near_null.ndim == 1:
            near_null = near_null[:, None]
        if nn_weights is None:
            nn_weights = create_weights(a, near_null)
        h = Hierarchy(config=self)
        h.matrices.append(a)
        h.near_nulls.append(near_null)
        h.nn_weights.append(np.asarray(nn_weights, dtype=np.float64))
        h.coarsen()
        return h


@dataclasses.dataclass
class Hierarchy:
    """Per-level setup artifacts (host CSR side).

    Index l holds level-l data; (restrictions[l], interpolations[l])
    transfer between level l and l+1.  The device-side solve structures
    are built by :class:`tpu_amg_torch.preconditioners.multigrid_builder.MultigridConfig`.
    """

    config: HierarchyConfig
    matrices: List[CSR] = dataclasses.field(default_factory=list)
    restrictions: List[CSR] = dataclasses.field(default_factory=list)
    interpolations: List[CSR] = dataclasses.field(default_factory=list)
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    partition_kinds: List[str] = dataclasses.field(default_factory=list)
    near_nulls: List[np.ndarray] = dataclasses.field(default_factory=list)
    nn_weights: List[np.ndarray] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    def coarsen(self):
        """Level loop (reference hierarchy.rs:190-248)."""
        max_levels = self.config.max_levels or 10**9
        level = 1
        while (
            self.matrices[-1].nrows > self.config.coarsest_dim
            and level < max_levels
        ):
            t0 = time.perf_counter()
            a = self.matrices[-1]
            galerkin = self.config.interpolation_config.build(
                a, self.near_nulls[-1], self.nn_weights[-1]
            )
            coarse = galerkin.coarse_mat
            if self.config.coarse_drop_tol:
                coarse = filter_matrix(
                    coarse, self.config.coarse_drop_tol, lump_abs=True
                ).with_block_size(coarse.block_size)
                galerkin = dataclasses.replace(galerkin, coarse_mat=coarse)
            coarse_nn = self._postprocess_near_null(coarse, galerkin.coarse_nn)
            self.add_level(galerkin, coarse_nn)
            logger.info(
                "created coarse level %d: n=%d nnz=%d (%.1fs)", level,
                coarse.nrows, coarse.nnz, time.perf_counter() - t0,
            )
            level += 1

    def _postprocess_near_null(self, coarse: CSR, coarse_nn: np.ndarray):
        """3 steps of l1-Jacobi error propagation + thin QR
        (hierarchy.rs:219-228, corrected semantics)."""
        device = resolve_device(self.config.device)
        op = SparseOperator.from_csr(coarse, device, torch.float64)
        m = DiagonalOperator(
            diag=to_device(l1_inverse_diag(coarse), device)
        )
        e = ErrorPropagator(a=op, m=m, iters=3)
        smoothed = e.mm(to_device(coarse_nn, device)).cpu().numpy()
        q, _ = np.linalg.qr(smoothed)
        return q

    def add_level(self, galerkin: GalerkinCoarse, coarse_nn: np.ndarray):
        """Push one level with the reference's dimension asserts
        (hierarchy.rs:250-271)."""
        p, r, coarse = (
            galerkin.interpolation,
            galerkin.restriction,
            galerkin.coarse_mat,
        )
        fine_n = self.matrices[-1].nrows
        if not (p.nrows == r.ncols == fine_n) or not (
            p.ncols == r.nrows == coarse.nrows
        ):
            raise ValueError(
                f"level dimension mismatch: fine n={fine_n}, "
                f"P {p.shape}, R {r.shape}, coarse n={coarse.nrows}"
            )
        self.matrices.append(coarse)
        self.interpolations.append(p)
        self.restrictions.append(r)
        self.partitions.append(galerkin.partition)
        self.partition_kinds.append(galerkin.kind)
        self.near_nulls.append(coarse_nn)
        self.nn_weights.append(create_weights(coarse, coarse_nn))

    # ------------------------------------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.matrices)

    def get_op(self, level: int) -> CSR:
        return self.matrices[level]

    def get_interpolation(self, level: int) -> CSR:
        return self.interpolations[level]

    def get_restriction(self, level: int) -> CSR:
        return self.restrictions[level]

    def get_near_null(self, level: int) -> np.ndarray:
        return self.near_nulls[level]

    def get_nn_weights(self, level: int) -> np.ndarray:
        return self.nn_weights[level]

    def grid_complexity(self) -> float:
        """Σ nₗ / n₀ (hierarchy.rs:346-350)."""
        return sum(m.nrows for m in self.matrices) / self.matrices[0].nrows

    def op_complexity(self) -> float:
        """Σ nnzₗ / nnz₀ (hierarchy.rs:352-360)."""
        return sum(m.nnz for m in self.matrices) / self.matrices[0].nnz

    def __repr__(self):
        rows = "\n".join(
            f"  level {lvl}: n={m.nrows} nnz={m.nnz} "
            f"nnz/row={m.nnz / max(m.nrows, 1):.1f}"
            for lvl, m in enumerate(self.matrices)
        )
        return (
            f"Hierarchy(levels={self.num_levels}, "
            f"gc={self.grid_complexity():.2f}, "
            f"oc={self.op_complexity():.2f})\n{rows}"
        )
