"""Adaptive (bootstrap) AMG: near-null discovery + composite enrichment.

Reference ``AdaptiveConfig`` / ``find_near_null`` / ``smooth_vector``
(adaptivity.rs:25-390), as in the JAX package's ``tpu_amg/adaptivity.py``:

1. ``find_near_null``: smooth ``near_null_dim`` random vectors with the
   l1-Jacobi error propagator E = I − M⁻¹A (QR re-orthonormalization
   between every sweep), build a :class:`BlockSmoother` from the
   resulting basis (partition cf = the smoothing block size), and smooth
   fresh random vectors with it.
2. Prepend the constant vector and thin-QR the basis; weights
   wₖ = 1/(vₖᵀAvₖ).
3. Build hierarchy + multigrid, wrap it in a multiplicative
   :class:`Composite`.
4. Enrichment loop: smooth fresh random vectors through the *current
   composite's* error propagator, use the smoothed basis and the
   measured per-vector convergence factors as the next component's
   near-null basis and weights, push the component (up to
   ``max_components``).

The sweeps run on the device as SpMM (K3 on a DIA matrix, else K1 + K2,
on an (n, k) block), whole V-cycles on the block, and a tall-skinny QR.
Random start blocks come from a ``torch.Generator`` (drawn on the CPU,
so they do not depend on the device) or are supplied by the caller.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.device import resolve_device, to_device
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.linop import DiagonalOperator, LinearOperator, SparseOperator
from tpu_amg_torch.ops.qr import orthonormalize
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.block_smoother import BlockSmoother
from tpu_amg_torch.preconditioners.composite import Composite
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.preconditioners.smoothers import l1_inverse_diag
from tpu_amg_torch.sparse import CSR

logger = logging.getLogger(__name__)


def _error_propagator(a: LinearOperator, m: LinearOperator):
    """x ↦ E x for E = I − M A.  A composite of more than one component
    takes the product form of the JAX package's
    ``_smooth_loop_composite``: the chain of steps x ← x − Mᵢ(A x) over
    the composite's sweep (the components reversed, then forward
    skipping the first).  It equals x − Composite(A x) only to rounding;
    the next hierarchy is built from the smoothed vectors and its
    partition is discrete, so the step order is the JAX package's."""
    if isinstance(m, Composite) and len(m.components) > 1:
        order = m.sweep()

        def eprop(x):
            for c in order:
                x = x - c.mm(a.mm(x))
            return x

        return eprop
    return lambda x: x - m.mm(a.mm(x))


def _smooth_loop(a: LinearOperator, m: LinearOperator, x0: torch.Tensor,
                 iterations: int):
    """iterations × (x ← QR(E x)) plus per-column convergence factors
    ‖Ex‖_A / ‖x‖_A (reference adaptivity.rs:307-390)."""
    eprop = _error_propagator(a, m)
    x = orthonormalize(x0)
    for _ in range(iterations):
        x = orthonormalize(eprop(x))
    ax = a.mm(x)
    w_norms = torch.sqrt(torch.einsum("nk,nk->k", x, ax))
    ev = eprop(x)
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
    dtype: torch.dtype = torch.float64,
):
    """Reference smooth_vector (adaptivity.rs:307-390).

    The start block is ``x0`` (n, near_null_dim) when given, else a
    standard normal draw from ``generator``.  Runs in ``dtype`` on
    ``device``.  Returns (basis (n, near_null_dim) float64 ndarray,
    convergence factors (k,) float64 ndarray)."""
    n = a.shape[0]
    if x0 is None:
        x0 = torch.randn(n, near_null_dim, generator=generator,
                         dtype=torch.float64)
    x0 = to_device(x0, device, dtype)
    x, cfs = _smooth_loop(a, m, x0, iterations)
    return x.cpu().double().numpy(), cfs.cpu().double().numpy()


def find_near_null(
    a: CSR,
    iterations: int,
    near_null_dim: int,
    smoothing_block_size: float,
    device,
    generator: Optional[torch.Generator] = None,
    starts: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    dtype: torch.dtype = torch.float64,
) -> np.ndarray:
    """Two-phase near-null bootstrap (reference adaptivity.rs:264-305).

    ``starts`` supplies the two start blocks (l1 phase, block phase);
    otherwise both are drawn from ``generator`` in that order.  Both
    smoothing phases run in ``dtype`` on ``device``: A (K1 + K2, or K3
    on a DIA matrix), the l1 diagonal 1 / Σⱼ|aᵢⱼ| rounded to ``dtype``,
    the block smoother's inverses and the QR.  float32 is the JAX
    package's accelerator bootstrap (``tpu_amg/adaptivity.py:246-281``);
    here the caller's dtype applies at every size (the JAX package takes
    that path only for n ≥ 2^15, and falls back to the host on any
    error; this function raises).  The partition between the phases is
    built on the host in float64, and the basis returns as a float64
    array whatever ``dtype`` is."""
    x1, x2 = starts if starts is not None else (None, None)
    op = SparseOperator.from_csr(a, device, dtype)
    l1 = DiagonalOperator(diag=to_device(l1_inverse_diag(a), device, dtype))
    basis, _ = smooth_vector(op, l1, iterations, near_null_dim, generator,
                             x1, device, dtype)

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
    block_pc = BlockSmoother.build(a, partition, device, dtype=dtype)
    basis, cfs = smooth_vector(op, block_pc, iterations, near_null_dim,
                               generator, x2, device, dtype)
    logger.info(
        "find_near_null: ||Ev||_A factors %s",
        np.array2string(cfs, precision=2),
    )
    return basis


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class AdaptiveConfig:
    """Defaults (adaptivity.rs:36-48): max_components 5, test_iters 50,
    coarsening_near_null_dim 32, constant prepended.

    The bootstrap runs in ``bootstrap_dtype`` (float64 unless the caller
    asks for float32: :func:`find_near_null`) on
    ``multigrid_config.device``; the enrichment smoothing runs there in
    ``multigrid_config.dtype``, the components' own."""

    hierarchy_config: HierarchyConfig = dataclasses.field(
        default_factory=HierarchyConfig
    )
    multigrid_config: MultigridConfig = dataclasses.field(
        default_factory=MultigridConfig
    )
    target_convergence: Optional[float] = None  # unused (parity with ref)
    max_components: int = 5
    test_iters: int = 50
    coarsening_near_null_dim: int = 32
    include_constant_first_near_null: bool = True
    bootstrap_dtype: torch.dtype = torch.float64

    def build(
        self,
        a: CSR,
        generator: Optional[torch.Generator] = None,
        *,
        near_null_starts: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        enrichment_starts: Optional[Sequence[np.ndarray]] = None,
        lambda_starts: Optional[Sequence[Sequence[np.ndarray]]] = None,
        return_hierarchies: bool = False,
        seconds: Optional[dict] = None,
    ):
        """Reference AdaptiveConfig::build (adaptivity.rs:50-165).

        Random draws: ``near_null_starts`` (the bootstrap's two
        (n, dim − 1) blocks) and ``enrichment_starts`` (one (n, dim)
        block a round), when given; otherwise each is drawn from
        ``generator`` (a CPU generator seeded with 0 when None) in that
        order: the two bootstrap blocks, then round 1's block, round 2's,
        and so on.  ``lambda_starts[c]``, when given, is component c's
        list of per-level Chebyshev start vectors
        (:meth:`MultigridConfig.build`).

        With ``return_hierarchies`` also returns the per-component
        hierarchies (the serializable setup artifact —
        ``utils/checkpoint.py`` ``save_composite_hierarchies``).  When
        ``seconds`` is a dict, the wall seconds of each phase go into it
        (the device synchronised at each phase's end): ``near_null``,
        ``hierarchy_c``, ``multigrid_c`` for component c = 1, 2, … and
        ``enrichment_c`` for the round that smooths component c's
        vectors."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seconds = {} if seconds is None else seconds
        device = resolve_device(self.multigrid_config.device)
        dtype = self.multigrid_config.dtype
        dim = self.coarsening_near_null_dim
        t0 = time.perf_counter()

        def lap(phase):
            nonlocal t0
            _sync(device)
            t = time.perf_counter()
            seconds[phase] = t - t0
            logger.info("setup phase %s: %.1fs", phase, t - t0)
            t0 = t

        nn = find_near_null(
            a,
            self.test_iters,
            dim - 1,
            self.multigrid_config.smoother_partitioner.coarsening_factor,
            device,
            generator=generator,
            starts=near_null_starts,
            dtype=self.bootstrap_dtype,
        )
        if self.include_constant_first_near_null:
            with_const = np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        else:
            with_const = np.concatenate([nn, nn[:, :1]], axis=1)
        basis, _ = np.linalg.qr(with_const)
        weights = create_weights(a, basis)
        logger.info("nn weights: %s", np.array2string(weights, precision=2))
        lap("near_null")

        def component(c, hierarchy):
            mg = self.multigrid_config.build(
                hierarchy, None if lambda_starts is None else lambda_starts[c]
            )
            lap(f"multigrid_{c + 1}")
            return mg

        hierarchy = self.hierarchy_config.build(a, basis, weights)
        logger.info("hierarchy 1:\n%r", hierarchy)
        lap("hierarchy_1")
        composite = Composite.from_hierarchies(
            a, [hierarchy], self.multigrid_config, lambda_starts)
        lap("multigrid_1")
        hierarchies: List = [hierarchy]

        for n_components in range(1, self.max_components):
            iters = max(self.test_iters // (2 * n_components - 1), 1)
            x0 = (None if enrichment_starts is None
                  else enrichment_starts[n_components - 1])
            smoothed, cfs = smooth_vector(
                composite.a, composite, iters, dim, generator, x0, device,
                dtype,
            )
            n_vcycles = 2 * n_components - 1
            logger.info(
                "component %d: ||Ev||_A^(1/%d) = %s",
                n_components,
                n_vcycles,
                np.array2string(cfs ** (1.0 / n_vcycles), precision=2),
            )
            lap(f"enrichment_{n_components + 1}")
            hierarchy = self.hierarchy_config.build(a, smoothed, cfs)
            logger.info("hierarchy %d:\n%r", n_components + 1, hierarchy)
            lap(f"hierarchy_{n_components + 1}")
            composite = composite.push(component(n_components, hierarchy))
            hierarchies.append(hierarchy)
        if return_hierarchies:
            return composite, hierarchies
        return composite
