"""Preconditioned conjugate gradients.

Replacement for faer's ``conjugate_gradient`` routine (consumed by the
reference at utils.rs:600-609 with ``CgParams``: abs tol 0, rel tol, max
iters).  Each iteration is one operator apply, one preconditioner
application, two dot products and vector AXPYs.

The loop is a Python loop that reads the residual norm to the host once
per iteration to test convergence; that read is also the residual
history.  One small device-to-host copy per iteration is cheap next to a
V-cycle, and the solve stops at exactly the iteration where it
converged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_amg_torch.linop import LinearOperator


def sdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real inner product (a 0-d tensor on the inputs' device)."""
    return torch.sum(a * b)


def snorm(a: torch.Tensor) -> torch.Tensor:
    """2-norm via sdot."""
    return torch.sqrt(torch.sum(a * a))


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
    x = torch.zeros_like(b) if x0 is None else x0
    apply_m = (lambda r: r) if m is None else m.mv
    threshold = max(rtol * float(snorm(b)), atol)

    r = b - a.mv(x)
    z = apply_m(r)
    p = z
    rz = sdot(r, z)
    res = float(snorm(r))
    hist = [res]
    k = 0
    while res > threshold and k < maxiter:
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
        r, rz = r_new, rz_new
        res = float(snorm(r))  # the one host read per iteration
        hist.append(res)
        k += 1
    info = SolveInfo(
        iters=k, converged=res <= threshold, res_norms=hist, final_res=res
    )
    return x, info
