"""Solver test harness and self-checking numerical utilities.

Reference ``test_solver`` (utils.rs:553-689), ``approx_convergence_factor``
(utils.rs:691-736), and ``symmetry_test`` (multigrid.rs:520-580), as in
the JAX package's ``tpu_amg/utils/testing.py``.  Random draws come from
a CPU ``torch.Generator``, or from ``starts`` where the caller hands in
its own (the tests hand in the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.solvers import cg, stationary_iteration

CONVERGENCE_SEED = 42  # the reference's default key for the ‖E‖_A estimate
SYMMETRY_SEED = 0


@dataclasses.dataclass
class SolverReport:
    """What the reference prints per run (examples/amg/main.rs:471-474)."""

    cg_iters: int
    cg_converged: bool
    sli_iters: int
    sli_converged: bool
    cg_history: np.ndarray
    sli_history: np.ndarray

    def reduction_factor(self) -> float:
        h = self.cg_history
        if len(h) < 2 or h[0] == 0:
            return 0.0
        return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1)))


def test_solver(
    a: LinearOperator,
    m: LinearOperator,
    b,
    x0=None,
    *,
    rtol: float = 1e-12,
    maxiter: int = 1000,
    run_sli: bool = True,
) -> SolverReport:
    """Run PCG and preconditioned stationary iteration on the same system
    and report iteration counts + residual histories
    (reference utils.rs:553-689).  ``run_sli=False`` skips the stationary
    solve (it runs to maxiter V-cycles on hard problems) and reports -1
    iterations for it.  ``b`` and ``x0`` are tensors on the operators'
    device."""
    _, cg_info = cg(a, b, m, x0, rtol=rtol, maxiter=maxiter)
    if run_sli:
        _, sli_info = stationary_iteration(
            a, b, m, x0, rtol=rtol, maxiter=maxiter
        )
        sli_iters = sli_info.iters
        sli_converged = sli_info.converged
        sli_history = sli_info.history()
    else:
        sli_iters, sli_converged = -1, False
        sli_history = np.zeros(1)
    return SolverReport(
        cg_iters=cg_info.iters,
        cg_converged=cg_info.converged,
        sli_iters=sli_iters,
        sli_converged=sli_converged,
        cg_history=cg_info.history(),
        sli_history=sli_history,
    )


def approx_convergence_factor(
    a: LinearOperator,
    m: LinearOperator,
    generator: Optional[torch.Generator] = None,
    *,
    num_iters: int = 100,
    num_vectors: int = 5,
    starts=None,
) -> float:
    """Estimate the asymptotic convergence factor ‖E‖_A of E = I − MA by
    power iteration on A-normalized random vectors
    (reference utils.rs:691-736: 100 iterations × 5 vectors, mean).

    ``a`` is a sparse or dense operator; its matrix's device is the
    device of the run.  The (n, num_vectors) start block is ``starts``
    when given, else a standard normal draw from ``generator`` (a CPU
    generator seeded with 42 when None).  Every apply is a block apply
    (``a.mm``, ``m.mm``): on the card K1's SpMM at k = num_vectors and
    the V-cycle on a block."""
    n = a.shape[0]
    if starts is None:
        if generator is None:
            generator = torch.Generator().manual_seed(CONVERGENCE_SEED)
        starts = torch.randn(n, num_vectors, generator=generator,
                             dtype=torch.float64)
    xs = to_device(starts, a.mat.device, torch.float64).contiguous()

    def a_norms(v):
        return torch.sqrt(torch.einsum("nm,nm->m", v, a.mm(v)))

    factors = torch.ones(num_vectors, dtype=xs.dtype, device=xs.device)
    for _ in range(num_iters):
        xs = xs / a_norms(xs)
        xs = xs - m.mm(a.mm(xs))
        factors = a_norms(xs)
    return float(torch.mean(factors))


def symmetry_test(
    m: LinearOperator,
    generator: Optional[torch.Generator] = None,
    num_tests: int = 5,
    rtol: float = 1e-10,
    *,
    starts: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    device="cuda",
) -> bool:
    """Check uᵀMv ≈ vᵀMu on random vectors (reference
    multigrid.rs:520-580): ``num_tests`` pairs (u, v), from ``starts``
    when given, else standard normal draws from ``generator`` (a CPU
    generator seeded with 0 when None), moved to ``device``, where ``m``
    lives."""
    n = m.shape[0]
    if starts is None:
        if generator is None:
            generator = torch.Generator().manual_seed(SYMMETRY_SEED)
        starts = [tuple(torch.randn(n, generator=generator,
                                    dtype=torch.float64) for _ in range(2))
                  for _ in range(num_tests)]
    ok = True
    for u, v in starts:
        u, v = (to_device(t, device, torch.float64) for t in (u, v))
        lhs = torch.dot(u, m.mv(v))
        rhs = torch.dot(v, m.mv(u))
        scale = torch.maximum(torch.abs(lhs), torch.abs(rhs))
        ok = ok and bool(
            torch.abs(lhs - rhs) <= rtol * torch.clamp(scale, min=1.0))
    return ok
