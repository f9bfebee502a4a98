"""Preconditioners: diagonal and Chebyshev smoothers, the block smoother,
dense coarse solvers, and the μ-cycle multigrid with its builder."""
