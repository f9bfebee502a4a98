"""Preconditioned stationary (Richardson) iteration.

Replacement for faer's ``stationary_iteration`` routine used by the
reference's ``test_solver`` (utils.rs:664-689):

    x_{k+1} = x_k + M(b - A x_k)

Note: the reference's own ``StationaryIteration::apply`` contains a bug
(it substitutes x for b after the first sweep, smoothers.rs:152-154;
SURVEY.md Appendix B).  Like the JAX package, this implements the
correct Richardson recurrence.

The residual b − A x computed after a sweep for the history is the next
sweep's residual as well: the JAX package computes it twice, with the
same bits, so each iteration here makes one operator apply fewer.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.shard_utils import snorm
from tpu_amg_torch.solvers.cg import iterate


def stationary_start(a: LinearOperator, b: torch.Tensor,
                     x0: Optional[torch.Tensor] = None):
    """The first state (b, x, r = b − A x) and ‖r‖ (a 0-d tensor)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a.mv(x)
    return (b, x, r), snorm(r)


def stationary_step(a: LinearOperator, m: Optional[LinearOperator] = None):
    """One sweep as a function of the state, (b, x, r) -> (the next
    state, ‖b − A x‖), with no host read in it; b passes through
    unchanged."""
    apply_m = (lambda r: r) if m is None else m.mv

    def step(state):
        b, x, r = state
        x = x + apply_m(r)
        r = b - a.mv(x)
        return (b, x, r), snorm(r)

    return step


def stationary_iteration(
    a: LinearOperator,
    b: torch.Tensor,
    m: Optional[LinearOperator] = None,
    x0: Optional[torch.Tensor] = None,
    *,
    rtol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Run preconditioned Richardson until ||r|| <= max(rtol*||b||, atol)
    or ``maxiter`` sweeps; returns (x, SolveInfo) with ‖b − A x‖ after
    each sweep as the history."""
    threshold = max(rtol * float(snorm(b)), atol)
    state, res = stationary_start(a, b, x0)
    state, info = iterate(stationary_step(a, m), state, float(res),
                          threshold, maxiter)
    return state[1], info
