"""Multigrid μ-cycle preconditioner.

Analog of the reference's ``Multigrid`` (reference multigrid.rs:172-518):
the cycle recursion mirrors multigrid.rs:269-380: pre-smooth
``smoothing_steps`` Richardson steps with the level smoother, restrict the
residual, recurse μ times, prolongate + correct, post-smooth; the
coarsest level applies the coarse solver directly.  Symmetric by
construction (rmv = mv; reference multigrid.rs:475-514 is symmetric-only
too).

All ops accept (n,) vectors or (n, k) blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpu_amg_torch.linop import LinearOperator


@dataclasses.dataclass
class Level:
    """One multigrid level: operator, smoother, and grid-transfer ops.

    ``r``/``p`` transfer between this level and the next-coarser one
    (absent on the coarsest level).
    """

    a: LinearOperator
    smoother: LinearOperator  # applied to residuals (M ≈ A⁻¹)
    r: Optional[LinearOperator] = None  # (n_c, n_f) restriction
    p: Optional[LinearOperator] = None  # (n_f, n_c) prolongation


@dataclasses.dataclass
class Multigrid(LinearOperator):
    """μ-cycle over a tuple of levels + coarse solver.

    mu=1 → V-cycle, mu=2 → W-cycle (reference MultigridConfig, μ default 1,
    multigrid.rs:27-44).
    """

    levels: Tuple[Level, ...]
    coarse_solver: LinearOperator
    mu: int = 1
    smoothing_steps: int = 1

    @property
    def shape(self):
        return self.levels[0].a.shape

    @property
    def num_levels(self) -> int:
        # levels holds the non-coarsest grids; coarsest is the solver
        return len(self.levels) + 1

    def _smooth(self, level: Level, v, f):
        """reference multigrid.rs:407-424 ``smooth`` helper."""
        for _ in range(self.smoothing_steps):
            v = v + level.smoother(f - level.a(v))
        return v

    def _cycle(self, idx: int, v, f):
        """reference multigrid.rs:269-380 ``cycle`` recursion."""
        if idx == len(self.levels):
            return self.coarse_solver(f)
        level = self.levels[idx]
        v = self._smooth(level, v, f)
        resid = f - level.a(v)
        f_c = level.r(resid)
        v_c = torch.zeros_like(f_c)
        for _ in range(self.mu):
            v_c = self._cycle(idx + 1, v_c, f_c)
        v = v + level.p(v_c)
        v = self._smooth(level, v, f)
        return v

    def _apply(self, rhs):
        return self._cycle(0, torch.zeros_like(rhs), rhs)

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)
