"""Preconditioned conjugate gradients.

Replacement for faer's ``conjugate_gradient`` routine (consumed by the
reference at utils.rs:600-609 with ``CgParams``: abs tol 0, rel tol, max
iters).  Each iteration is one operator apply, one preconditioner
application, two dot products and vector AXPYs.

The loop (:func:`iterate`, shared with the stationary solve) is a Python
loop that reads the residual norm to the host once per iteration to test
convergence; that read is also the residual history.  One small
device-to-host copy per iteration is cheap next to a V-cycle, and the
solve stops at exactly the iteration where it converged.  An iteration
is a function of the loop's state (:func:`cg_step`) with no host read in
it, so that ``AMGSolver.compile`` can capture it in a CUDA graph.  The
dot products are :func:`tpu_amg_torch.shard_utils.sdot`, all-reduced
over the active solver group in a sharded solve.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.shard_utils import sdot, snorm


@dataclasses.dataclass
class SolveInfo:
    """Result metadata (faer ``CgInfo`` analog)."""

    iters: int  # iterations performed
    converged: bool
    res_norms: List[float]  # absolute residual 2-norms, one per iterate
    final_res: float

    def history(self) -> np.ndarray:
        """Residual history (iters + 1 entries) as a numpy array."""
        return np.asarray(self.res_norms)


def iterate(step, state, res: float, threshold: float, maxiter: int):
    """The loop every solve shares: ``state, res = step(state)`` while
    res > threshold and fewer than ``maxiter`` steps ran, reading each
    step's residual norm (a 0-d tensor) to the host once; that read is
    the history.  Returns (the last state, SolveInfo)."""
    hist = [res]
    k = 0
    while res > threshold and k < maxiter:
        state, res_t = step(state)
        res = float(res_t)  # the one host read per iteration
        hist.append(res)
        k += 1
    info = SolveInfo(
        iters=k, converged=res <= threshold, res_norms=hist, final_res=res
    )
    return state, info


def cg_start(a: LinearOperator, b: torch.Tensor,
             m: Optional[LinearOperator] = None,
             x0: Optional[torch.Tensor] = None):
    """PCG's first state (x, r, p, rᵀz) and ‖r‖ (a 0-d tensor)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a.mv(x)
    z = r if m is None else m.mv(r)
    return (x, r, z, sdot(r, z)), snorm(r)


def cg_step(a: LinearOperator, m: Optional[LinearOperator] = None,
            flexible: bool = False):
    """One PCG iteration as a function of the state, (x, r, p, rᵀz) ->
    (the next state, ‖r‖): one operator apply, one preconditioner
    application, two dot products and the AXPYs, with no host read (so
    that a CUDA graph can capture it)."""
    apply_m = (lambda r: r) if m is None else m.mv

    def step(state):
        x, r, p, rz = state
        ap = a.mv(p)
        alpha = rz / sdot(p, ap)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = apply_m(r_new)
        rz_new = sdot(r_new, z)
        if flexible:
            # Polak-Ribière (Notay's flexible CG): re-orthogonalizes
            # against the previous residual so a slightly-varying or
            # inexact M cannot break the p-conjugacy recurrence
            beta = sdot(r_new - r, z) / rz
        else:
            beta = rz_new / rz
        p = z + beta * p
        return (x, r_new, p, rz_new), snorm(r_new)

    return step


def cg(
    a: LinearOperator,
    b: torch.Tensor,
    m: Optional[LinearOperator] = None,
    x0: Optional[torch.Tensor] = None,
    *,
    rtol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
    flexible: bool = False,
):
    """Solve A x = b with (optionally preconditioned) CG.

    Args:
      a: SPD operator.
      m: preconditioner applied as z = M(r) ≈ A⁻¹r (SPD). None → identity.
      x0: initial guess (zeros if None).
      rtol/atol: stop when ||r|| <= max(rtol*||b||, atol).
      maxiter: iteration cap.
      flexible: use the Polak-Ribière beta (FCG): β = zᵀ(r−r_prev)/zᵀ_prev r_prev.
        Robust to preconditioners that are not exactly a fixed SPD operator.

    Returns:
      (x, SolveInfo)
    """
    threshold = max(rtol * float(snorm(b)), atol)
    state, res = cg_start(a, b, m, x0)
    state, info = iterate(cg_step(a, m, flexible), state, float(res),
                          threshold, maxiter)
    return state[0], info
