"""Chebyshev polynomial smoother.

The reference leaves Gauss-Seidel unimplemented (smoothers.rs:26-27);
the parallel smoother of choice is a Chebyshev polynomial in D⁻¹A: it
needs only SpMVs and AXPYs, with no triangular solves and no sequential
dependencies (see PAPERS.md, "Optimal Polynomial Smoothers for Parallel
AMG").

This implements the classic three-term recurrence targeting the upper
part [λ_max/ratio, λ_max] of the spectrum of D⁻¹A (hypre/PyAMG
convention), with λ_max estimated by power iteration at build time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.linop import LinearOperator

LAMBDA_SEED = 7  # the reference draws the power-iteration start from a fixed key


def estimate_lambda_max(
    a: LinearOperator,
    d_inv: torch.Tensor,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    iters: int = 20,
) -> float:
    """Power-iteration estimate of λ_max(D⁻¹A) (scaled by 1.05 safety).

    The start vector is ``v0`` when given, else a standard normal draw
    from ``generator`` (a CPU generator seeded with 7 when None), made on
    the CPU so that it does not depend on the device."""
    n = a.shape[0]
    if v0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(LAMBDA_SEED)
        v0 = torch.randn(n, generator=generator, dtype=torch.float64)
    v = to_device(v0, d_inv.device, d_inv.dtype)
    for _ in range(iters):
        w = d_inv * a.mv(v)
        v = w / torch.linalg.vector_norm(w)
    lam = torch.dot(v, d_inv * a.mv(v)) / torch.dot(v, v)
    return 1.05 * float(lam)


@dataclasses.dataclass
class ChebyshevSmoother(LinearOperator):
    """Degree-k Chebyshev smoother as a preconditioner application
    x = p(D⁻¹A) D⁻¹ b targeting [λ_max/ratio, λ_max].

    Symmetric whenever A and D are (polynomial in a self-adjoint
    operator w.r.t. the D-inner product).
    """

    a: LinearOperator
    d_inv: torch.Tensor
    lam_max: float
    lam_min: float
    degree: int = 3

    @property
    def shape(self):
        return self.a.shape

    @staticmethod
    def build(
        a: LinearOperator,
        d_inv: torch.Tensor,
        degree: int = 3,
        ratio: float = 30.0,
        v0: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> "ChebyshevSmoother":
        lam_max = estimate_lambda_max(a, d_inv, v0=v0, generator=generator)
        return ChebyshevSmoother(
            a=a, d_inv=d_inv, lam_max=lam_max, lam_min=lam_max / ratio,
            degree=degree,
        )

    def _apply(self, b):
        """Three-term Chebyshev recurrence (PyAMG/hypre formulation)."""
        theta = 0.5 * (self.lam_max + self.lam_min)
        delta = 0.5 * (self.lam_max - self.lam_min)
        sigma = theta / delta
        rho = 1.0 / sigma

        dinv = self.d_inv[:, None] if b.dim() > 1 else self.d_inv
        # x_1 = (1/theta) D^-1 b
        x = (dinv * b) / theta
        d = x  # correction term
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - self.a(x)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (dinv * r)
            x = x + d
            rho = rho_new
        return x

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)
