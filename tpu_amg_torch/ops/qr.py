"""Tall-skinny orthonormalization of candidate blocks.

``orthonormalize`` is a Householder thin QR, as the reference uses for
unsharded inputs (``tpu_amg/ops/qr.py``), so that both packages return
the same columns, signs included.  ``cholesky_qr`` is CholeskyQR2 (two
rounds of G = XᵀX, L = chol(G), X ← X·L⁻ᵀ), the form a row-sharded
basis needs: its only reduction is the k×k Gram matrix.

Both use ``torch.linalg`` on small k×k or (n, k) problems; they are
setup work outside the kernels.  A row-sharded X (each rank of a solver
group holding its rows, :mod:`tpu_amg_torch.parallel`) takes CholeskyQR2
with G all-reduced over the group: the k×k Gram matrix is the only thing
that crosses ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_amg_torch.shard_utils import SolverGroup, all_reduce_sum


def cholesky_qr(x: torch.Tensor, iters: int = 2,
                group: Optional[SolverGroup] = None) -> torch.Tensor:
    """Orthonormalize the columns of x (n × k) by CholeskyQR2; with a
    ``group``, x is this rank's rows and G is summed over the group."""
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    eps = torch.finfo(x.dtype).eps
    for _ in range(iters):
        g = x.T @ x
        if group is not None:
            g = all_reduce_sum(g, group)
        # small jitter guards exactly-rank-deficient inputs
        g = g + (eps * torch.trace(g)) * eye
        chol = torch.linalg.cholesky(g)
        x = x @ torch.linalg.inv(chol).T
    return x


def orthonormalize(x: torch.Tensor,
                   group: Optional[SolverGroup] = None) -> torch.Tensor:
    """Q of the thin Householder QR of x, as a row-major tensor; for a
    row-sharded x (this rank's rows over ``group``), CholeskyQR2, as the
    JAX package takes it on sharded inputs."""
    if group is not None:
        return cholesky_qr(x, group=group)
    q, _ = torch.linalg.qr(x)
    return q.contiguous()
