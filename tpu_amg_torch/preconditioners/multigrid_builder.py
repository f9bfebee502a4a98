"""Builder: Hierarchy → device-side Multigrid preconditioner.

Reference ``MultigridConfig::build`` (multigrid.rs:27-165): for each
non-coarsest level build the level operator and its smoother, and a
direct coarse solver on the last level.  (The reference's level loop
contains a latent wrong-operator fallback — multigrid.rs:147 falls back
to the finest op — which is not replicated; SURVEY.md Appendix B.)

Each level operator is dense at or under ``dense_threshold`` rows
(``torch.matmul``); above it, ``SparseOperator.from_csr`` with the wide
DIA envelope of the JAX builder (160 diagonals, density 8.0,
tpu_amg/preconditioners/multigrid_builder.py:179-185) picks DIA through
K3 for diagonal-structured levels and CSR through K1 + K2 otherwise.
P and R are rectangular, so always CSR; R is its own materialized CSR
(the hierarchy stores R = Pᵀ).  Levels keep their hierarchy ordering: a
reordering is a similarity and changes no iterate.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_amg_torch.device import resolve_device, to_device
from tpu_amg_torch.hierarchy import Hierarchy
from tpu_amg_torch.linop import DenseOperator, SparseOperator
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.block_smoother import BlockSmoother
from tpu_amg_torch.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg_torch.preconditioners.coarse import build_coarse_solver
from tpu_amg_torch.preconditioners.multigrid import Level, Multigrid
from tpu_amg_torch.preconditioners.smoothers import build_smoother

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MultigridConfig:
    """Defaults: μ=1 (SA), smoothing_steps 1, Cholesky coarsest
    (multigrid.rs:35-44); smoother partition cf defaults to the CLI's
    block_smoother_size 128 (examples/amg/main.rs:107).

    ``smoother``: "block" (the reference's additive-Schwarz
    BlockSmoother), "chebyshev" (degree-``chebyshev_degree`` polynomial
    in D⁻¹A), or "l1"/"l2"/"jacobi" diagonal smoothing.
    """

    mu: Optional[int] = None
    smoothing_steps: int = 1
    coarse_solver: str = "cholesky"
    smoother: str = "block"
    chebyshev_degree: int = 3
    smoother_partitioner: PartitionerConfig = dataclasses.field(
        default_factory=lambda: PartitionerConfig(coarsening_factor=128.0)
    )
    dtype: torch.dtype = torch.float64
    device: str = "cuda"
    dense_threshold: int = 2048  # densify small coarse levels

    def _build_smoother(self, a, nn, w, a_op, device, lambda_start):
        if self.smoother == "block":
            cfg = self.smoother_partitioner
            # cap cf so at least 2 aggregates exist
            n_nodes = a.nrows // a.block_size
            if cfg.coarsening_factor > n_nodes / 2:
                cfg = dataclasses.replace(
                    cfg, coarsening_factor=max(n_nodes / 2.0, 1.0)
                )
            partition = cfg.build_partition(a, nn, w).expand_blocks(
                a.block_size
            )
            return BlockSmoother.build(a, partition, device, self.dtype)
        if self.smoother == "chebyshev":
            d_inv = to_device(1.0 / a.abs_row_sums(), device, self.dtype)
            return ChebyshevSmoother.build(
                a_op, d_inv, degree=self.chebyshev_degree, v0=lambda_start
            )
        if self.smoother == "jacobi":
            return build_smoother("jacobi", a, device, self.dtype, omega=0.66)
        return build_smoother(self.smoother, a, device, self.dtype)

    def build(
        self,
        hierarchy: Hierarchy,
        lambda_starts: Optional[Sequence[np.ndarray]] = None,
    ) -> Multigrid:
        """``lambda_starts[l]``, when given, is the start vector of level
        l's Chebyshev λ_max power iteration."""
        device = resolve_device(self.device)
        level_count = hierarchy.num_levels
        levels = []
        for lvl in range(level_count - 1):
            a = hierarchy.get_op(lvl)
            if a.nrows <= self.dense_threshold:
                a_op = DenseOperator(
                    mat=to_device(a.to_dense(), device, self.dtype)
                )
            else:
                a_op = SparseOperator.from_csr(
                    a, device, self.dtype, dia_max_diags=160,
                    dia_max_density=8.0,
                )
            smoother = self._build_smoother(
                a, hierarchy.get_near_null(lvl), hierarchy.get_nn_weights(lvl),
                a_op, device,
                None if lambda_starts is None else lambda_starts[lvl],
            )
            p_op = SparseOperator.from_csr(
                hierarchy.get_interpolation(lvl), device, self.dtype
            )
            r_op = SparseOperator.from_csr(
                hierarchy.get_restriction(lvl), device, self.dtype
            )
            n_coarse = hierarchy.get_op(lvl + 1).nrows
            if (
                r_op.shape != (n_coarse, a.nrows)
                or p_op.shape != (a.nrows, n_coarse)
                or smoother.shape[0] != a.nrows
            ):
                raise ValueError(
                    f"level {lvl} assembly mismatch: A n={a.nrows}, "
                    f"R {r_op.shape}, P {p_op.shape}, smoother "
                    f"{smoother.shape}, coarse n={n_coarse}"
                )
            levels.append(Level(a=a_op, smoother=smoother, r=r_op, p=p_op))
        coarse = build_coarse_solver(
            self.coarse_solver, hierarchy.get_op(level_count - 1), device,
            self.dtype,
        )
        return Multigrid(
            levels=tuple(levels),
            coarse_solver=coarse,
            mu=1 if self.mu is None else self.mu,  # SA hierarchies: V-cycle
            smoothing_steps=self.smoothing_steps,
        )
