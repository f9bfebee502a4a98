"""Randomized SVD (Halko-Martinsson-Tropp) on matrix-free operators.

Reference ``rand_svd`` (decompositions/rand_svd.rs:25-102), as in the
JAX package's ``tpu_amg/decompositions/rand_svd.py``: Y = A·Ω (Gaussian,
rank + oversample columns), optional subspace iteration (AAᵀ)^q,
Q = thin-QR(Y), B = AᵀQ, SVD of Bᵀ, U = Q·Ũ.  Works on any operator with
mm/rmm, so it runs matrix-free on an ErrorPropagator for near-null
extraction (reference smooth_vector_rand_svd, adaptivity.rs:248-262).

The operator's applies are the sparse kernels or dense matmuls; the QR
and the small SVD are ``torch.linalg`` calls on the operator's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_amg_torch.device import resolve_device, to_device
from tpu_amg_torch.linop import LinearOperator


def rand_svd(
    a: LinearOperator,
    rank: int,
    oversample: int = 10,
    subspace_iters: int = 0,
    generator: Optional[torch.Generator] = None,
    omega=None,
    device="cuda",
):
    """Approximate top-``rank`` SVD of a, whose tensors lie on
    ``device``.

    Ω (n, rank + oversample) is ``omega`` when given (an array or a
    tensor, placed in float64), else a standard normal float64 draw from
    ``generator`` (a CPU generator seeded with 0 when None).  Returns (U (m, rank),
    s (rank,), V (n, rank)) on ``device`` with A ≈ U diag(s) Vᵀ."""
    m, n = a.shape
    ell = rank + oversample
    if omega is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        omega = torch.randn(n, ell, generator=generator, dtype=torch.float64)
    omega = to_device(omega, resolve_device(device), torch.float64)
    y = a.mm(omega)
    for _ in range(subspace_iters):
        y = a.mm(a.rmm(y))
    q, _ = torch.linalg.qr(y)
    b = a.rmm(q)  # (n, ell) = Aᵀ Q
    # SVD of Bᵀ = (ell, n): Bᵀ = Ũ S Vᵀ  →  A ≈ Q Ũ S Vᵀ
    u_t, s, vh = torch.linalg.svd(b.T, full_matrices=False)
    u = q @ u_t
    return u[:, :rank], s[:rank], vh[:rank].T


def smooth_vector_rand_svd(error_propagator: LinearOperator,
                           near_null_dim: int, iterations: int,
                           generator: Optional[torch.Generator] = None,
                           omega=None, device="cuda"):
    """Near-null extraction via rand-SVD of the error propagator
    (reference adaptivity.rs:248-262): the dominant right singular
    vectors of E^q are the slowest-to-converge modes."""
    _, _, v = rand_svd(
        error_propagator,
        near_null_dim,
        oversample=10,
        subspace_iters=iterations,
        generator=generator,
        omega=omega,
        device=device,
    )
    return v
