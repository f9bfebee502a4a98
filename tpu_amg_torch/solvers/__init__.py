"""Krylov and relaxation solvers."""

from tpu_amg_torch.solvers.cg import SolveInfo, cg
from tpu_amg_torch.solvers.stationary import stationary_iteration

__all__ = ["SolveInfo", "cg", "stationary_iteration"]
