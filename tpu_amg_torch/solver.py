"""High-level solver facade: one-call setup + reusable solves.

    solver = AMGSolver.setup(csr_matrix, SolverConfig(device="cuda"))
    x, info = solver.solve(b)                      # repeatable
    solver.save("hier.npz")                        # checkpoint
    AMGSolver.load("hier.npz", a, config)          # and resume

Setup bootstraps a near-null basis on the device, builds the SA
(``method="sa"``) or classical CR+LS (``method="classical"``) hierarchy
on the host, and builds the device-side multigrid (a V-cycle for SA, a
W-cycle for classical unless ``mu`` says otherwise), or builds the
adaptive composite of several SA multigrids (``method="adaptive"``,
:class:`AdaptiveConfig`); ``solve`` runs PCG (or stationary iteration)
preconditioned by that cycle or composite, through
:meth:`AMGSolver.compile`: on a CUDA device one iteration of the solve
is captured in a CUDA graph and replayed.
``cycle_precision`` evaluates the V-cycle or composite in a narrower
dtype (:mod:`tpu_amg_torch.precision`), after setup and after load; the
outer Krylov loop and ``AMGSolver.op`` keep ``dtype``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_amg_torch.adaptivity import AdaptiveConfig, find_near_null
from tpu_amg_torch.device import disable_tf32, resolve_device, to_device
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.precision import cast_preconditioner
from tpu_amg_torch.preconditioners.composite import Composite
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solvers import cg, stationary_iteration
from tpu_amg_torch.solvers.cg import cg_start, cg_step, iterate, snorm
from tpu_amg_torch.solvers.graph import GraphStep
from tpu_amg_torch.solvers.stationary import stationary_start, stationary_step
from tpu_amg_torch.sparse import CSR

logger = logging.getLogger(__name__)


SETUP_METHODS = ("sa", "classical", "adaptive")


@dataclasses.dataclass
class SolverConfig:
    """One knob set covering the reference CLI's surface
    (examples/amg/main.rs:32-121).  ``device`` is explicit: "cuda"
    raises when PyTorch sees no card, and nothing falls back to the CPU.
    """

    method: str = "sa"  # "sa" | "classical" | "adaptive"
    # NOTE: the effective aggregation size is coarsening_factor *
    # interp_near_null_dim / block_size (reference mod.rs:135-137).
    # Keep it >= ~25 for 3-D scalar problems — too-small aggregates with
    # smoothed P densify the Galerkin coarse operators.
    coarsening_near_null_dim: int = 16
    interp_near_null_dim: int = 4  # SA candidate dimension
    sa_filter_theta: Optional[float] = None  # filtered-SA P smoothing
    sa_trunc_tol: Optional[float] = None  # P truncation
    coarse_drop_tol: Optional[float] = None  # non-Galerkin coarse drop
    smoothing_iters: int = 20
    coarsening_factor: float = 8.0
    aggregation_iters: int = 100
    coarsest_dim: int = 1000
    max_levels: Optional[int] = None
    smoother: str = "chebyshev"  # "block" | "chebyshev" | "l1" | ...
    smoothing_steps: int = 2
    dense_threshold: int = 2048  # levels at or under this are dense
    mu: Optional[int] = None  # auto: 1 for SA, 2 for classical
    block_smoother_size: float = 128.0
    composite_components: int = 3  # for method="adaptive"
    reorder: bool = False  # RCM renumbering (utils/reorder.py) before setup
    dtype: torch.dtype = torch.float64
    # the near-null bootstrap's smoothing dtype (find_near_null): float32
    # is the JAX package's accelerator bootstrap; the basis and the host
    # setup stay float64 either way
    bootstrap_dtype: torch.dtype = torch.float64
    # the cycle's precision (precision.py MODES): None keeps ``dtype``;
    # "f64"/"f32" cast its arrays; "bf16_values" stores them in bf16
    # (vectors stay ``dtype``); "bf16" runs the cycle's vectors in bf16
    cycle_precision: Optional[str] = None
    device: str = "cuda"
    seed: int = 0

    def __post_init__(self):
        if self.method not in SETUP_METHODS:
            raise ValueError(f"unknown method {self.method!r} "
                             f"(one of {SETUP_METHODS})")
        resolve_device(self.device)


def scalar_3d_config(device: str = "cuda", **overrides) -> SolverConfig:
    """The scalar 3-D SA config of the JAX package's ``tools/setup3d.py``,
    in float64: the SA path of ``chip_smoke.py`` and of the row-block
    probe (``tools/rowblocks.py``)."""
    kw = dict(
        coarsening_near_null_dim=8, interp_near_null_dim=2,
        coarsening_factor=16.0, smoothing_steps=1, smoothing_iters=10,
        coarsest_dim=1500, dense_threshold=8192, sa_trunc_tol=0.1,
        coarse_drop_tol=0.01, dtype=torch.float64, device=device,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def elasticity_3d_config(device: str = "cuda", **overrides) -> SolverConfig:
    """The block-3 elasticity SA config of the JAX package's
    ``tools/setup3d.py --elasticity`` (rigid modes span 6: cd 12 / 6,
    cf 16, P truncation 0.05, coarse drop 0.01), in float64 like
    :func:`scalar_3d_config`: the elasticity path of ``chip_smoke.py``
    and of ``tools/setup3d.py``."""
    kw = dict(
        coarsening_near_null_dim=12, interp_near_null_dim=6,
        coarsening_factor=16.0, smoothing_steps=1, smoothing_iters=8,
        coarsest_dim=1500, dense_threshold=8192, sa_trunc_tol=0.05,
        coarse_drop_tol=0.01, dtype=torch.float64, device=device,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def unstructured_config(device: str = "cuda", **overrides) -> SolverConfig:
    """The SA config of the JAX package's ``bench_unstructured.py``
    (cd 8 / 2, one smoothing step, 10 smoothing iterations, coarsest
    1500, float32, levels at or under 8192 rows dense): the unstructured
    2-D bench (``tools/bench_unstructured.py``) and the real-FEM solve of
    ``chip_smoke.py``."""
    kw = dict(
        coarsening_near_null_dim=8, interp_near_null_dim=2,
        smoothing_steps=1, smoothing_iters=10, coarsest_dim=1500,
        dtype=torch.float32, dense_threshold=8192, device=device,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def setup_draws(n: int, config: SolverConfig):
    """The random blocks :meth:`AMGSolver.setup` draws from its CPU
    generator seeded with ``config.seed`` when the caller passes none, in
    its order: (``near_null_starts``: the bootstrap's two (n, cd − 1)
    blocks, ``enrichment_starts``: one (n, cd) block a round of the
    adaptive composite, none for SA or classical).  Passing them gives
    the same setup bit for bit; a second setup from the same blocks in
    another dtype starts where the first did."""
    g = torch.Generator().manual_seed(config.seed)
    dim = config.coarsening_near_null_dim
    starts = tuple(torch.randn(n, dim - 1, generator=g,
                               dtype=torch.float64).numpy() for _ in range(2))
    rounds = (config.composite_components - 1
              if config.method == "adaptive" else 0)
    blocks = [torch.randn(n, dim, generator=g, dtype=torch.float64).numpy()
              for _ in range(rounds)]
    return starts, blocks


SOLVE_METHODS = ("cg", "stationary")


class AMGSolver:
    def __init__(self, a: CSR, preconditioner, hierarchy=None,
                 config: Optional[SolverConfig] = None,
                 perm: Optional[np.ndarray] = None,
                 op: Optional[SparseOperator] = None):
        """``op`` is A on the device when the caller holds it already (a
        composite's operator), else it is built from ``a``."""
        self.config = config or SolverConfig()
        self.device = resolve_device(self.config.device)
        self.matrix = a
        self.op = (op if op is not None
                   else SparseOperator.from_csr(a, self.device,
                                                self.config.dtype))
        self.preconditioner = preconditioner
        self.hierarchy = hierarchy
        self.component_hierarchies = None  # the adaptive composite's
        self.setup_seconds = {}  # phase -> wall seconds
        self._compiled = {}  # (rtol, maxiter, method) -> solve function
        self._graphs = {}  # (method, n, dtype) -> GraphStep
        # RCM permutation: the solve runs in the reordered numbering; b,
        # x0 and x are translated
        self.perm = self.inv_perm = None
        if perm is not None:
            inv = np.empty(len(perm), dtype=np.int64)
            inv[perm] = np.arange(len(perm))
            self.perm = torch.as_tensor(perm, device=self.device)
            self.inv_perm = torch.as_tensor(inv, device=self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def setup(
        a: CSR,
        config: Optional[SolverConfig] = None,
        *,
        near_null_starts: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        enrichment_starts: Optional[Sequence[np.ndarray]] = None,
        lambda_starts: Optional[Sequence] = None,
    ) -> "AMGSolver":
        """Bootstrap + hierarchy + multigrid (``method="sa"`` or
        ``"classical"``), or the adaptive composite
        (``method="adaptive"``).

        Random draws (the two near-null start blocks, and for the
        adaptive composite one enrichment block a round) come from a CPU
        ``torch.Generator`` seeded with ``config.seed``, or from
        ``near_null_starts`` / ``enrichment_starts``
        (:meth:`AdaptiveConfig.build`).  ``lambda_starts`` are passed to
        :meth:`MultigridConfig.build`: per level for SA, and for the
        adaptive composite a list of those per component."""
        config = config or SolverConfig()
        device = resolve_device(config.device)
        disable_tf32()  # full-precision float32 matmuls on the solve path
        perm = None
        if config.reorder:
            from tpu_amg_torch.utils.reorder import rcm_reorder

            a, perm, _ = rcm_reorder(a)
        interp = InterpolationConfig(
            kind="classical" if config.method == "classical"
            else "aggregation",
            aggregation=AggregationConfig(
                candidate_dimension=config.interp_near_null_dim,
                filter_theta=config.sa_filter_theta,
                trunc_tol=config.sa_trunc_tol,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=config.coarsening_factor,
                    max_improvement_iters=config.aggregation_iters,
                ),
            ),
        )
        hier_cfg = HierarchyConfig(
            coarsest_dim=config.coarsest_dim,
            interpolation_config=interp,
            max_levels=config.max_levels,
            coarse_drop_tol=config.coarse_drop_tol,
            device=config.device,
        )
        mg_cfg = AMGSolver._mg_config(config)
        generator = torch.Generator().manual_seed(config.seed)
        seconds = {}
        if config.method == "adaptive":
            pc, hierarchies = AdaptiveConfig(
                hierarchy_config=hier_cfg,
                multigrid_config=mg_cfg,
                max_components=config.composite_components,
                test_iters=config.smoothing_iters,
                coarsening_near_null_dim=config.coarsening_near_null_dim,
                bootstrap_dtype=config.bootstrap_dtype,
            ).build(a, generator, near_null_starts=near_null_starts,
                    enrichment_starts=enrichment_starts,
                    lambda_starts=lambda_starts, return_hierarchies=True,
                    seconds=seconds)
            # op: the composite's A, before the cast
            solver = AMGSolver(
                a, cast_preconditioner(pc, config.cycle_precision),
                config=config, perm=perm, op=pc.a)
            solver.component_hierarchies = hierarchies
            solver.setup_seconds = seconds
            return solver
        t0 = time.perf_counter()
        nn = find_near_null(
            a,
            config.smoothing_iters,
            config.coarsening_near_null_dim - 1,
            config.block_smoother_size,
            device,
            generator=generator,
            starts=near_null_starts,
            dtype=config.bootstrap_dtype,
        )
        basis, _ = np.linalg.qr(
            np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        )
        t1 = time.perf_counter()
        seconds["near_null"] = t1 - t0
        hierarchy = hier_cfg.build(a, basis, create_weights(a, basis))
        t2 = time.perf_counter()
        seconds["hierarchy"] = t2 - t1
        mg = cast_preconditioner(mg_cfg.build(hierarchy, lambda_starts),
                                 config.cycle_precision)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds["multigrid"] = time.perf_counter() - t2
        for phase, s in seconds.items():
            logger.info("setup phase %s: %.1fs", phase, s)
        solver = AMGSolver(a, mg, hierarchy=hierarchy, config=config,
                           perm=perm)
        solver.setup_seconds = seconds
        return solver

    # ------------------------------------------------------------------
    def _as_device(self, v) -> torch.Tensor:
        return to_device(v, self.device, self.config.dtype)

    def compile(self, *, rtol: float = 1e-8, maxiter: int = 500,
                method: str = "cg"):
        """The solve function ``fn(b, x0=None) -> (x, SolveInfo)`` for
        one (rtol, maxiter, method), cached per key as in the JAX
        package; ``method`` is "cg" (PCG) or "stationary".

        On a CUDA device one iteration of the method's loop (operator
        apply, V-cycle, dots, AXPYs and ‖r‖) is captured in a CUDA graph
        at the first solve of each method, length and dtype (the step
        does not depend on rtol or maxiter, so every key shares it;
        :class:`tpu_amg_torch.solvers.graph.GraphStep`) and replayed
        once an iteration, ‖r‖ read after each replay: the iterations,
        history and x are the eager solve's.  A failed capture raises.
        On the CPU the function is the eager solve."""
        if method not in SOLVE_METHODS:
            raise ValueError(f"unknown solve method {method!r} "
                             f"(one of {SOLVE_METHODS})")
        key = (rtol, maxiter, method)
        if key in self._compiled:
            return self._compiled[key]
        op, pc = self.op, self.preconditioner
        if method == "cg":
            eager_solve, x_at, step = cg, 0, cg_step(op, pc)

            def start(b, x0):
                return cg_start(op, b, pc, x0)
        else:
            eager_solve, x_at, step = (stationary_iteration, 1,
                                        stationary_step(op, pc))

            def start(b, x0):
                return stationary_start(op, b, x0)

        def eager(b, x0=None):
            return eager_solve(op, b, pc, x0, rtol=rtol, maxiter=maxiter)

        def replayed(b, x0=None):
            threshold = rtol * float(snorm(b))
            state, res = start(b, x0)
            gkey = (method, b.shape[0], b.dtype)
            if gkey not in self._graphs:
                self._graphs[gkey] = GraphStep(step, state)
            graph = self._graphs[gkey]
            graph.load(state)
            state, info = iterate(graph, graph.state, float(res), threshold,
                                  maxiter)
            return state[x_at].clone(), info

        fn = replayed if self.device.type == "cuda" else eager
        self._compiled[key] = fn
        return fn

    def solve(self, b, x0=None, *, rtol: float = 1e-8, maxiter: int = 500,
              method: str = "cg"):
        """PCG (default) or stationary solve through :meth:`compile`
        (cached per (rtol, maxiter, method)); returns (x on the device,
        SolveInfo)."""
        b = self._as_device(b)
        x0 = None if x0 is None else self._as_device(x0)
        if self.perm is not None:
            b = b[self.perm]
            x0 = None if x0 is None else x0[self.perm]
        x, info = self.compile(rtol=rtol, maxiter=maxiter, method=method)(b, x0)
        if self.perm is not None:
            x = x[self.inv_perm]
        return x, info

    def apply_preconditioner(self, r):
        return self.preconditioner.mv(self._as_device(r))

    def save(self, path) -> None:
        """Checkpoint the setup artifact (``utils/checkpoint.py``, the JAX
        package's format): the hierarchy (SA, classical) or the
        per-component hierarchies (adaptive composite)."""
        from tpu_amg_torch.utils import checkpoint

        if self.hierarchy is not None:
            checkpoint.save_hierarchy(path, self.hierarchy)
            return
        if not self.component_hierarchies:
            raise ValueError(
                "solver has neither a hierarchy nor component hierarchies"
            )
        checkpoint.save_composite_hierarchies(path,
                                              self.component_hierarchies)

    # ------------------------------------------------------------------
    @staticmethod
    def _mg_config(config: SolverConfig) -> MultigridConfig:
        return MultigridConfig(
            mu=config.mu,
            smoothing_steps=config.smoothing_steps,
            smoother=config.smoother,
            dtype=config.dtype,
            device=config.device,
            dense_threshold=config.dense_threshold,
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=config.block_smoother_size,
                max_improvement_iters=50,
            ),
        )

    @staticmethod
    def load(path, a: CSR, config: Optional[SolverConfig] = None,
             *, lambda_starts: Optional[Sequence] = None,
             ) -> "AMGSolver":
        """Rebuild a solver from a checkpoint written by :meth:`save` or
        by the JAX package (``tpu_amg.AMGSolver.save``): a single
        hierarchy or an adaptive composite's (the format
        self-identifies).  ``lambda_starts`` as in :meth:`setup`."""
        from tpu_amg_torch.utils import checkpoint

        config = config or SolverConfig()
        disable_tf32()
        mg_cfg = AMGSolver._mg_config(config)
        with np.load(path) as z:
            composite = "components" in checkpoint.read_meta(z)
        if composite:
            hierarchies = checkpoint.load_composite_hierarchies(path)
            pc = Composite.from_hierarchies(a, hierarchies, mg_cfg,
                                            lambda_starts)
            solver = AMGSolver(
                a, cast_preconditioner(pc, config.cycle_precision),
                config=config, op=pc.a)
            solver.component_hierarchies = hierarchies
            return solver
        hierarchy = checkpoint.load_hierarchy(path)
        mg = cast_preconditioner(mg_cfg.build(hierarchy, lambda_starts),
                                 config.cycle_precision)
        return AMGSolver(a, mg, hierarchy=hierarchy, config=config)
