"""Preconditioners: diagonal and Chebyshev smoothers, the block smoother,
dense coarse solvers, the μ-cycle multigrid with its builder, and the
multiplicative composite of the adaptive path."""

from tpu_amg_torch.preconditioners.composite import Composite

__all__ = ["Composite"]
