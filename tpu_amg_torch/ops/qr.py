"""Tall-skinny orthonormalization of candidate blocks.

``orthonormalize`` is a Householder thin QR, as the reference uses for
unsharded inputs (``tpu_amg/ops/qr.py``), so that both packages return
the same columns, signs included.  ``cholesky_qr`` is CholeskyQR2 (two
rounds of G = XᵀX, L = chol(G), X ← X·L⁻ᵀ), the form a row-sharded
basis needs: its only reduction is the k×k Gram matrix.

Both use ``torch.linalg`` on small k×k or (n, k) problems; they are
setup work outside the kernels.
"""

from __future__ import annotations

import torch


def cholesky_qr(x: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Orthonormalize the columns of x (n × k) by CholeskyQR2."""
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    eps = torch.finfo(x.dtype).eps
    for _ in range(iters):
        g = x.T @ x
        # small jitter guards exactly-rank-deficient inputs
        g = g + (eps * torch.trace(g)) * eye
        chol = torch.linalg.cholesky(g)
        x = x @ torch.linalg.inv(chol).T
    return x


def orthonormalize(x: torch.Tensor) -> torch.Tensor:
    """Q of the thin Householder QR of x, as a row-major tensor."""
    q, _ = torch.linalg.qr(x)
    return q.contiguous()
