"""Typed error hierarchy for setup/solve failure detection.

The reference panics on every error path but carries commented-out error
enums showing the intended design (``HierarchyError`` hierarchy.rs:363-401,
``MultigridBuildError`` multigrid.rs:582-608).  This realizes that
intent: structured exceptions with enough context to drive retry /
degradation logic (e.g. an adaptive setup catching
``CoarseningStalled`` and loosening the coarsening factor).

The same classes, with the same bases and ``__init__`` signatures, as
the JAX package's ``tpu_amg.errors``: a caller catches the same type
from either package.
"""

from __future__ import annotations


class TpuAmgError(Exception):
    """Base class for all tpu-amg errors."""


class SparseFormatError(TpuAmgError, ValueError):
    """Invalid sparse construction (shape/index/block-size violations)."""


class PartitionError(TpuAmgError, ValueError):
    """Partition invariant violation (non-bijective map, empty agg)."""


class CoarseningStalled(TpuAmgError):
    """Coarsening cannot reach the target factor (graph exhausted).

    Reference analog: the greedy partitioner's warn-and-break
    (modularity.rs:183-186); raised instead when progress is impossible.
    """

    def __init__(self, target_cf: float, achieved_cf: float):
        self.target_cf = target_cf
        self.achieved_cf = achieved_cf
        super().__init__(
            f"coarsening stalled: target cf {target_cf:.2f}, "
            f"achieved {achieved_cf:.2f}"
        )


class HierarchyError(TpuAmgError):
    """Level construction failure (dimension mismatch, empty level)."""


class MultigridBuildError(TpuAmgError):
    """Preconditioner assembly failure (reference multigrid.rs:582-608)."""


class SingularBlockError(TpuAmgError):
    """A local diagonal block is numerically singular
    (reference asserts: interpolation/mod.rs:934, 1000-1004)."""


class ConvergenceError(TpuAmgError):
    """A solve failed to reach tolerance within the iteration budget."""

    def __init__(self, iters: int, residual: float, tol: float):
        self.iters = iters
        self.residual = residual
        self.tol = tol
        super().__init__(
            f"no convergence in {iters} iterations "
            f"(residual {residual:.3e}, tol {tol:.3e})"
        )
