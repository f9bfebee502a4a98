"""High-level solver facade: one-call setup + reusable solves.

    solver = AMGSolver.setup(csr_matrix, SolverConfig(device="cuda"))
    x, info = solver.solve(b)                      # repeatable
    AMGSolver.load("hier.npz", a, config)          # from a checkpoint

Setup bootstraps a near-null basis on the device, builds the SA
hierarchy on the host, and builds the device-side multigrid; ``solve``
runs PCG preconditioned by that V-cycle.  Only ``method="sa"`` is
ported.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.adaptivity import find_near_null
from tpu_amg_torch.device import disable_tf32, resolve_device, to_device
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse import CSR

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SolverConfig:
    """One knob set covering the reference CLI's surface
    (examples/amg/main.rs:32-121).  ``device`` is explicit: "cuda"
    raises when PyTorch sees no card, and nothing falls back to the CPU.
    """

    method: str = "sa"
    # NOTE: the effective aggregation size is coarsening_factor *
    # interp_near_null_dim / block_size (reference mod.rs:135-137).
    # Keep it >= ~25 for 3-D scalar problems — too-small aggregates with
    # smoothed P densify the Galerkin coarse operators.
    coarsening_near_null_dim: int = 16
    interp_near_null_dim: int = 4  # SA candidate dimension
    sa_filter_theta: Optional[float] = None  # filtered-SA P smoothing
    sa_trunc_tol: Optional[float] = None  # P truncation
    coarse_drop_tol: Optional[float] = None  # non-Galerkin coarse drop
    smoothing_iters: int = 20
    coarsening_factor: float = 8.0
    aggregation_iters: int = 100
    coarsest_dim: int = 1000
    max_levels: Optional[int] = None
    smoother: str = "chebyshev"  # "block" | "chebyshev" | "l1" | ...
    smoothing_steps: int = 2
    dense_threshold: int = 2048  # levels at or under this are dense
    mu: Optional[int] = None  # auto: 1 for SA
    block_smoother_size: float = 128.0
    dtype: torch.dtype = torch.float64
    device: str = "cuda"
    seed: int = 0

    def __post_init__(self):
        if self.method != "sa":
            raise NotImplementedError(f"method {self.method!r} (only 'sa')")
        resolve_device(self.device)


def scalar_3d_config(device: str = "cuda", **overrides) -> SolverConfig:
    """The scalar 3-D SA config of the JAX package's ``tools/setup3d.py``,
    in float64: the SA path of ``chip_smoke.py`` and of the row-block
    probe (``tools/rowblocks.py``)."""
    kw = dict(
        coarsening_near_null_dim=8, interp_near_null_dim=2,
        coarsening_factor=16.0, smoothing_steps=1, smoothing_iters=10,
        coarsest_dim=1500, dense_threshold=8192, sa_trunc_tol=0.1,
        coarse_drop_tol=0.01, dtype=torch.float64, device=device,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


class AMGSolver:
    def __init__(self, a: CSR, preconditioner, hierarchy=None,
                 config: Optional[SolverConfig] = None):
        self.config = config or SolverConfig()
        self.device = resolve_device(self.config.device)
        self.matrix = a
        self.op = SparseOperator.from_csr(a, self.device, self.config.dtype)
        self.preconditioner = preconditioner
        self.hierarchy = hierarchy
        self.setup_seconds = {}  # phase -> wall seconds

    # ------------------------------------------------------------------
    @staticmethod
    def setup(
        a: CSR,
        config: Optional[SolverConfig] = None,
        *,
        near_null_starts: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        lambda_starts: Optional[Sequence[np.ndarray]] = None,
    ) -> "AMGSolver":
        """Bootstrap + hierarchy + multigrid.

        Random draws (the two near-null start blocks) come from a CPU
        ``torch.Generator`` seeded with ``config.seed``, or from
        ``near_null_starts``; ``lambda_starts`` are passed to
        :meth:`MultigridConfig.build`."""
        config = config or SolverConfig()
        device = resolve_device(config.device)
        disable_tf32()  # full-precision float32 matmuls on the solve path
        interp = InterpolationConfig(
            aggregation=AggregationConfig(
                candidate_dimension=config.interp_near_null_dim,
                filter_theta=config.sa_filter_theta,
                trunc_tol=config.sa_trunc_tol,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=config.coarsening_factor,
                    max_improvement_iters=config.aggregation_iters,
                ),
            ),
        )
        hier_cfg = HierarchyConfig(
            coarsest_dim=config.coarsest_dim,
            interpolation_config=interp,
            max_levels=config.max_levels,
            coarse_drop_tol=config.coarse_drop_tol,
            device=config.device,
        )
        seconds = {}
        t0 = time.perf_counter()
        nn = find_near_null(
            a,
            config.smoothing_iters,
            config.coarsening_near_null_dim - 1,
            config.block_smoother_size,
            device,
            generator=torch.Generator().manual_seed(config.seed),
            starts=near_null_starts,
        )
        basis, _ = np.linalg.qr(
            np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        )
        t1 = time.perf_counter()
        seconds["near_null"] = t1 - t0
        hierarchy = hier_cfg.build(a, basis, create_weights(a, basis))
        t2 = time.perf_counter()
        seconds["hierarchy"] = t2 - t1
        mg = AMGSolver._mg_config(config).build(hierarchy, lambda_starts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds["multigrid"] = time.perf_counter() - t2
        for phase, s in seconds.items():
            logger.info("setup phase %s: %.1fs", phase, s)
        solver = AMGSolver(a, mg, hierarchy=hierarchy, config=config)
        solver.setup_seconds = seconds
        return solver

    # ------------------------------------------------------------------
    def _as_device(self, v) -> torch.Tensor:
        return to_device(v, self.device, self.config.dtype)

    def solve(self, b, x0=None, *, rtol: float = 1e-8, maxiter: int = 500):
        """PCG preconditioned by the multigrid cycle; returns
        (x on the device, SolveInfo)."""
        b = self._as_device(b)
        x0 = None if x0 is None else self._as_device(x0)
        return cg(self.op, b, self.preconditioner, x0, rtol=rtol,
                  maxiter=maxiter)

    def apply_preconditioner(self, r):
        return self.preconditioner.mv(self._as_device(r))

    # ------------------------------------------------------------------
    @staticmethod
    def _mg_config(config: SolverConfig) -> MultigridConfig:
        return MultigridConfig(
            mu=config.mu,
            smoothing_steps=config.smoothing_steps,
            smoother=config.smoother,
            dtype=config.dtype,
            device=config.device,
            dense_threshold=config.dense_threshold,
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=config.block_smoother_size,
                max_improvement_iters=50,
            ),
        )

    @staticmethod
    def load(path, a: CSR, config: Optional[SolverConfig] = None,
             *, lambda_starts: Optional[Sequence[np.ndarray]] = None,
             ) -> "AMGSolver":
        """Rebuild a solver from a single-hierarchy checkpoint written by
        the JAX package (``tpu_amg.AMGSolver.save``)."""
        from tpu_amg_torch.utils.checkpoint import load_hierarchy

        config = config or SolverConfig()
        disable_tf32()
        hierarchy = load_hierarchy(path)
        mg = AMGSolver._mg_config(config).build(hierarchy, lambda_starts)
        return AMGSolver(a, mg, hierarchy=hierarchy, config=config)
