"""Multiplicative composite preconditioner.

Reference ``Composite`` (composite.rs:48-99): holds the system operator A
and a tuple of component preconditioners; an apply is a symmetric
multiplicative sweep — components in reverse order, then forward order
skipping the first (error form E = E₀ᵀ…Eₙᵀ Eₙ…E₁E₀ with Eᵢ = I − MᵢA) —
updating the work residual ws = rhs − A·out after every component but
the last (composite.rs:66-83).

The work residual after the last component is never read.  The JAX
package computes it and leaves it to XLA to drop inside ``jit``; here
the apply runs eagerly or is captured in a CUDA graph, so it is not
computed: n components cost 2n − 1 component applies and 2n − 2 applies
of A.

Adaptive AMG (:mod:`tpu_amg_torch.adaptivity`) enriches the composite by
pushing further multigrid components; ``push`` returns a new Composite.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tpu_amg_torch.device import resolve_device
from tpu_amg_torch.linop import LinearOperator, SparseOperator


@dataclasses.dataclass(frozen=True)
class Composite(LinearOperator):
    a: LinearOperator
    components: Tuple[LinearOperator, ...]

    @classmethod
    def from_hierarchies(cls, a, hierarchies, mg_cfg,
                         lambda_starts=None) -> "Composite":
        """The composite of one multigrid a hierarchy, each built by
        ``mg_cfg`` (``MultigridConfig.build`` with ``lambda_starts[c]``
        for component c, when given), around the CSR ``a`` on
        ``mg_cfg``'s device and dtype."""
        op = SparseOperator.from_csr(a, resolve_device(mg_cfg.device),
                                     mg_cfg.dtype)
        return cls(a=op, components=tuple(
            mg_cfg.build(h, None if lambda_starts is None
                         else lambda_starts[c])
            for c, h in enumerate(hierarchies)))

    @property
    def shape(self):
        return self.a.shape

    def push(self, component: LinearOperator) -> "Composite":
        return Composite(a=self.a, components=self.components + (component,))

    def sweep(self) -> list:
        """The components in the order an apply runs them: reversed, then
        forward skipping the first (reference composite.rs:69-81)."""
        return list(reversed(self.components)) + list(self.components[1:])

    def _apply(self, rhs):
        order = self.sweep()
        out = torch.zeros_like(rhs)
        ws = rhs
        for i, comp in enumerate(order):
            out = out + comp(ws)
            if i + 1 < len(order):
                ws = rhs - self.a(out)
        return out

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)
