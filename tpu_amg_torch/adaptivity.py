"""Near-null bootstrap: smooth random candidates toward the near-null space.

Reference ``find_near_null`` / ``smooth_vector`` (adaptivity.rs:264-390):

1. Smooth ``near_null_dim`` random vectors with the l1-Jacobi error
   propagator E = I − M⁻¹A (QR re-orthonormalization between every
   sweep).
2. Partition A by the smoothed basis (cf = the smoothing block size),
   build a :class:`BlockSmoother` on that partition, and smooth fresh
   random vectors with it.

The sweeps run on the device as SpMM (K1 + K2 on an (n, k) block) and a
tall-skinny QR.  Random start blocks come from a ``torch.Generator``
(drawn on the CPU, so they do not depend on the device) or are supplied
by the caller.  The adaptive composite (the enrichment loop) is not
ported yet.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import to_device
from tpu_amg_torch.hierarchy import create_weights
from tpu_amg_torch.linop import DiagonalOperator, LinearOperator, SparseOperator
from tpu_amg_torch.ops.qr import orthonormalize
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.block_smoother import BlockSmoother
from tpu_amg_torch.preconditioners.smoothers import l1_inverse_diag
from tpu_amg_torch.sparse import CSR

logger = logging.getLogger(__name__)


def _run(a: LinearOperator, m: LinearOperator, x0: torch.Tensor,
         iterations: int):
    """iterations × (x ← QR(E x)) plus per-column convergence factors
    ‖Ex‖_A / ‖x‖_A (reference adaptivity.rs:307-390)."""
    x = orthonormalize(x0)
    for _ in range(iterations):
        x = orthonormalize(x - m.mm(a.mm(x)))
    ax = a.mm(x)
    w_norms = torch.sqrt(torch.einsum("nk,nk->k", x, ax))
    ev = x - m.mm(ax)
    aev = a.mm(ev)
    ev_norms = torch.sqrt(torch.einsum("nk,nk->k", ev, aev))
    return x, ev_norms / w_norms


def smooth_vector(
    a: LinearOperator,
    m: LinearOperator,
    iterations: int,
    near_null_dim: int,
    generator: Optional[torch.Generator] = None,
    x0: Optional[np.ndarray] = None,
    device=None,
):
    """Reference smooth_vector (adaptivity.rs:307-390).

    The start block is ``x0`` (n, near_null_dim) when given, else a
    standard normal draw from ``generator``.  Runs in float64 on
    ``device``.  Returns (basis (n, near_null_dim) ndarray, convergence
    factors (k,) ndarray)."""
    n = a.shape[0]
    if x0 is None:
        x0 = torch.randn(n, near_null_dim, generator=generator,
                         dtype=torch.float64)
    x0 = to_device(x0, device, torch.float64)
    x, cfs = _run(a, m, x0, iterations)
    return x.cpu().numpy(), cfs.cpu().numpy()


def find_near_null(
    a: CSR,
    iterations: int,
    near_null_dim: int,
    smoothing_block_size: float,
    device,
    generator: Optional[torch.Generator] = None,
    starts: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> np.ndarray:
    """Two-phase near-null bootstrap (reference adaptivity.rs:264-305).

    ``starts`` supplies the two start blocks (l1 phase, block phase);
    otherwise both are drawn from ``generator`` in that order.  Runs in
    float64 on ``device``."""
    x1, x2 = starts if starts is not None else (None, None)
    op = SparseOperator.from_csr(a, device, torch.float64)
    l1 = DiagonalOperator(diag=to_device(l1_inverse_diag(a), device))
    basis, _ = smooth_vector(op, l1, iterations, near_null_dim, generator,
                             x1, device)

    p_cfg = PartitionerConfig(
        coarsening_factor=min(
            smoothing_block_size, max(a.nrows / a.block_size / 2.0, 1.0)
        ),
        max_improvement_iters=50,
    )
    weights = create_weights(a, basis)
    partition = p_cfg.build_partition(a, basis, weights).expand_blocks(
        a.block_size
    )
    block_pc = BlockSmoother.build(a, partition, device)
    basis, cfs = smooth_vector(op, block_pc, iterations, near_null_dim,
                               generator, x2, device)
    logger.info(
        "find_near_null: ||Ev||_A factors %s",
        np.array2string(cfs, precision=2),
    )
    return basis
