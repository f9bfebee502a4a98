"""Krylov solvers."""

from tpu_amg_torch.solvers.cg import SolveInfo, cg

__all__ = ["SolveInfo", "cg"]
