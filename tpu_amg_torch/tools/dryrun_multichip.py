"""The multi-rank dry run: the sharded solve step, held against one rank.

Port of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:80-497``)
to ``torch.distributed``, one rank a shard.  Four phases, each with its
gate; any failed gate raises, so a failed rank exits non-zero:

1. a (N/2 × 2) grid of subgroups, rows × near-null candidates: one
   damped error-propagation sweep (the row-sharded all-gather SpMM) and
   the row-sharded CholeskyQR2 (G all-reduced over the rows), against the
   same sweep on one rank (even N only, as in the JAX package);
2. the deep 5,184-dof unstructured system (a 72² RCM-ordered jittered
   Delaunay Poisson graph) with a 4-level SA hierarchy, block smoothers
   and the banded Cholesky coarse solve, sharded with a halo fine level
   (``HaloCSR``, K1 + K2), sharded block smoothers and the
   replicate-below boundary: a 3-iteration float32 PCG, sharded equal to
   one rank within 2e-6;
3. block-3 unstructured elasticity, side 18 (17,496 dofs), on a halo fine
   level where the per-rank window holds the band (the JAX phase's side
   12 fits none, VERDICT.md:237-241); the same PCG, within 2e-6;
4. the 5,184-dof graph without its diagonal shift (near-singular), in
   float64 with the pseudo-inverse coarse solve: within 1e-12.

Phases 2-4's setups are built once, rank i building setup i mod the
ranks, and shared (``parallel.dist.replicate``); every rank runs the
single-rank reference itself.

    torchrun --nproc-per-node 2 -m tpu_amg_torch.tools.dryrun_multichip \\
        --backend gloo --device cpu
    python -m tpu_amg_torch.tools.dryrun_multichip --backend nccl  # 1 rank

NCCL takes one rank per GPU; ranks sharing one card run gloo (their
vectors staged through the host at each collective).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from tpu_amg_torch.linop import LinearOperator, SparseOperator
from tpu_amg_torch.parallel import multihost
from tpu_amg_torch.parallel.dist import (ShardedBlockSmoother, ShardedSolve,
                                         make_solver_mesh, pad_csr_identity,
                                         replicate, shard_csr, shard_vector,
                                         solve_sharded)
from tpu_amg_torch.shard_utils import SolverGroup, all_gather_rows

F32_GATE = 2e-6  # __graft_entry__.py:290 and :407
F64_GATE = 1e-12  # __graft_entry__.py:487
SWEEP_GATE = 1e-5  # phase 1, float32 (the JAX gate is the shape alone)
# levels under this many rows run replicated (the JAX dry run's 600, for
# its levels): the deep system's levels are 5,184 / 2,036 / 894 and its
# coarsest 339, so level 1 is sharded and level 2 replicated at 2 and 4
# ranks, and the shard/replicate boundary is crossed in every cycle
REPLICATE_BELOW = 1000
ELASTICITY_SIDE = 18
DEEP_SIDE = 72  # 5,184 = 2^6 3^4 dofs


class GateFailed(RuntimeError):
    pass


def gate(ok: bool, msg: str) -> None:
    if not ok:
        raise GateFailed(msg)


STRENGTH_DEPTH = 1  # the partitioners' strength-graph BFS depth


def sa_setup(a, nn, candidates: int, cf: float, coarsest: int,
             max_levels: int, coarse: str, dtype, device):
    """The JAX dry run's hierarchy and multigrid: aggregation with
    ``candidates`` near-null vectors, 1 smoothing step of the block
    smoother (cf 32), every level sparse (``dense_threshold`` 0).  The
    partitioners reach ``STRENGTH_DEPTH`` = 1 neighbours where the JAX
    phases take the default 3: the dry run holds the sharded cycle
    against one rank, not the aggregates' quality, and depth 3 on the
    block-3 rows (~48 entries) takes 10 of its 12 s of host setup."""
    from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
    from tpu_amg_torch.interpolation import (AggregationConfig,
                                             InterpolationConfig)
    from tpu_amg_torch.partition import PartitionerConfig
    from tpu_amg_torch.preconditioners.multigrid_builder import (
        MultigridConfig)

    h = HierarchyConfig(
        coarsest_dim=coarsest, max_levels=max_levels, device=device,
        interpolation_config=InterpolationConfig(
            kind="aggregation", aggregation=AggregationConfig(
                candidate_dimension=candidates,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=cf, max_improvement_iters=5,
                    max_depth=STRENGTH_DEPTH))),
    ).build(a, nn, create_weights(a, nn))
    return MultigridConfig(
        smoothing_steps=1, smoother="block", coarse_solver=coarse,
        dtype=dtype, device=device, dense_threshold=0,
        smoother_partitioner=PartitionerConfig(
            coarsening_factor=32.0, max_improvement_iters=5,
            max_depth=STRENGTH_DEPTH),
    ).build(h)


@dataclasses.dataclass
class Padded(LinearOperator):
    """``inner`` on the first ``n_orig`` rows of a whole vector, the
    identity on the padding rows (``__graft_entry__``'s PaddedPrecond)."""

    inner: LinearOperator
    n_orig: int
    n_pad: int

    @property
    def shape(self):
        return (self.n_pad, self.n_pad)

    def mv(self, r):
        return torch.cat([self.inner.mv(r[:self.n_orig]), r[self.n_orig:]])


def sharded_pcg(a_csr, mg, group: SolverGroup, b: np.ndarray, dtype,
                device, rtol: float) -> ShardedSolve:
    """The system padded with identity rows to a multiple of the group
    (its multigrid, the unpadded system's, then runs replicated), and
    ``maxiter`` 3 PCG of b sharded over the group against the same on
    one rank (``parallel.dist.solve_sharded``)."""
    n_orig = a_csr.nrows
    padded = pad_csr_identity(a_csr, group.size)
    n = padded.nrows
    b_pad = torch.as_tensor(np.concatenate([b, np.ones(n - n_orig)]),
                            dtype=dtype, device=device)
    return solve_sharded(
        SparseOperator.from_csr(padded, device, dtype),
        mg if n == n_orig else Padded(mg, n_orig, n), b_pad, group,
        rtol=rtol, maxiter=3, replicate_below=REPLICATE_BELOW)


def phase_grid(group: SolverGroup, device, a) -> str:
    """Phase 1: rows × candidates on a (N/2 × 2) grid of subgroups, on
    phase 2's matrix ``a``."""
    import torch.distributed as dist

    from tpu_amg_torch.ops.qr import cholesky_qr, orthonormalize
    from tpu_amg_torch.shard_utils import SolverGroup as Group
    n_rows, k = group.size // 2, 8
    ranks = dist.get_process_group_ranks(group.group)
    i, j = divmod(group.index, 2)
    # this rank's two subgroups, made by their members alone: the row
    # blocks of candidate block j, the candidate blocks of row block i
    rows = Group(dist.new_group([ranks[r * 2 + j] for r in range(n_rows)],
                                use_local_synchronization=True),
                 n_rows, i, group.backend)
    cands = Group(dist.new_group([ranks[i * 2], ranks[i * 2 + 1]],
                                 use_local_synchronization=True),
                  2, j, group.backend)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (a.nrows, k)), dtype=torch.float32)
    cols = slice(j * k // 2, (j + 1) * k // 2)
    e = shard_csr(a, rows, device, torch.float32)
    v = shard_vector(x[:, cols].contiguous(), rows, device)
    ev = v - 0.66 * e.mm(v)  # one damped error-propagation sweep
    full = all_gather_rows(ev.T.contiguous(), cands).T.contiguous()
    q = orthonormalize(full, group=rows)[:, cols]  # CholeskyQR2
    # the same on one rank (CholeskyQR2 too: Householder's Q differs)
    e1 = SparseOperator.from_csr(a, device, torch.float32)
    x1 = x.to(device)
    q1 = cholesky_qr(x1 - 0.66 * e1.mm(x1))[rows.rows(a.nrows), cols]
    err = float((q - q1).abs().max())
    gate(tuple(q.shape) == (a.nrows // n_rows, k // 2) and err < SWEEP_GATE,
         f"2-D grid sweep: shape {tuple(q.shape)}, sharded vs one rank "
         f"{err:.2e} (gate {SWEEP_GATE:.0e})")
    return (f"dryrun 2-D grid ({n_rows}x2 rows x candidates) OK: the sweep "
            f"and CholeskyQR2 of an ({a.nrows}, {k}) block, sharded == "
            f"single max err {err:.1e}")


@dataclasses.dataclass
class System:
    """One solve of phases 2-4: the host matrix, its multigrid (on the
    device), the right-hand side, the PCG's rtol and the gate."""

    label: str
    a: object
    mg: object
    b: np.ndarray
    dtype: torch.dtype
    rtol: float
    limit: float


def _deep(device) -> System:
    from tpu_amg_torch.utils.problems import unstructured_poisson_2d

    # diag_shift 0.05 as in the JAX phase: the pure graph Laplacian is
    # near-singular and a 3-iteration float32 CG amplifies roundoff along
    # the near-null constant (phase 4 covers that in float64)
    a = unstructured_poisson_2d(DEEP_SIDE, diag_shift=0.05)
    return System("deep", a, sa_setup(a, np.ones((a.nrows, 1)), 1, 4.0, 100,
                                      4, "banded", torch.float32, device),
                  np.ones(a.nrows), torch.float32, 1e-5, F32_GATE)


def _block3(device) -> System:
    from tpu_amg_torch.utils.problems import unstructured_elasticity_3d

    a3 = unstructured_elasticity_3d(ELASTICITY_SIDE, diag_shift=0.05)
    # rigid translations: the truss model's exact near-null directions
    nn3 = np.zeros((a3.nrows, 3))
    for d in range(3):
        nn3[d::3, d] = 1.0
    basis, _ = np.linalg.qr(nn3)
    # coarsening factor 8 (the JAX phase's 4 at its side 12): at side 18
    # a factor of 4 keeps 2/5 of the rows a level and its Galerkin
    # products take minutes of host setup
    return System("block3", a3, sa_setup(a3, basis, 3, 8.0, 200, 3,
                                         "cholesky", torch.float32, device),
                  np.ones(a3.nrows), torch.float32, 1e-5, F32_GATE)


def _f64(device) -> System:
    from tpu_amg_torch.utils.problems import unstructured_poisson_2d

    a4 = unstructured_poisson_2d(DEEP_SIDE, diag_shift=0.0)
    # the exact constant is A's null vector (its weight 1/v'Av blows up):
    # a smoothed-random near-null, as the bootstrap would supply
    rng = np.random.default_rng(0)
    nn = np.ones((a4.nrows, 1)) + 0.05 * rng.standard_normal((a4.nrows, 1))
    mg4 = sa_setup(a4, nn, 1, 4.0, 100, 4, "pinv", torch.float64, device)
    # a zero-mean right-hand side keeps the singular system consistent
    b = rng.standard_normal(a4.nrows)
    b -= b.mean()
    return System("f64", a4, mg4, b, torch.float64, 1e-10, F64_GATE)


def build_systems(group: SolverGroup, device) -> list:
    """Phases 2-4's setups, in order, on every rank of ``group``: setup i
    is built by row block i mod the group's size, side by side, and
    shared (``parallel.dist.replicate``)."""
    builds = (lambda: _deep(device),
              lambda: _block3(device),
              lambda: _f64(device))
    mine = {i: build() for i, build in enumerate(builds)
            if i % group.size == group.index}
    return [replicate(mine.get(i), group, src=i % group.size)
            for i in range(len(builds))]


def phase_solve(group: SolverGroup, device, sys_: System) -> str:
    """Phases 2-4: the sharded 3-iteration PCG of one system against one
    rank's."""
    run = sharded_pcg(sys_.a, sys_.mg, group, sys_.b, sys_.dtype, device,
                      sys_.rtol)
    fine, forms, err = type(run.fine).__name__, run.forms, run.rel_err
    divisible = sys_.a.nrows % group.size == 0
    sharded_blocks = any(isinstance(lv.smoother, ShardedBlockSmoother)
                         for lv in getattr(run.pc, "levels", ()))
    # every fine level is a halo one where the group divides the system
    # (block-3 too: VERDICT.md:237-241)
    gate(not divisible or fine == "HaloCSR",
         f"{sys_.label}: fine level is {fine}, not HaloCSR")
    if sys_.label == "deep":
        # the replicate-below boundary must be active: the round-3
        # shard/replicate crash class lived on it
        # (__graft_entry__.py:212-214)
        # (one rank divides every level: only the coarse solve is
        # replicated there)
        gate(not divisible or (forms[0] == "HaloCSR" and sharded_blocks
                               and ("replicated" in forms
                                    or group.size == 1)),
             f"the sharded cycle's levels {forms}: a halo fine level, "
             "sharded block smoothers and a replicated level expected")
    if sys_.label == "block3":
        gate(not divisible or sharded_blocks,
             "block-3 dry run must exercise sharded block smoothers")
    gate(err < sys_.limit, f"{sys_.label}: sharded 3-iteration PCG diverges "
         f"from one rank: rel err {err:.2e} (gate {sys_.limit:.0e})")
    head = {
        "deep": f"dryrun_multichip OK: {group.size} ranks, n={sys_.a.nrows}",
        "block3": f"dryrun block-3 elasticity OK: n={sys_.a.nrows} "
                  "(block_size 3)",
        "f64": f"dryrun f64 near-singular OK: n={sys_.a.nrows} (no "
               "diagonal shift)",
    }[sys_.label]
    return (f"{head}, fine={fine}, levels {forms} + "
            f"{type(sys_.mg.coarse_solver).__name__}, cg iters="
            f"{run.info.iters}, sharded==single rel err {err:.1e}")


def dryrun_multichip(group: SolverGroup, device, systems: list) -> list:
    """The four phases on ``group`` (ranks outside it return at once),
    phases 2-4 on ``systems`` (:func:`build_systems`): one line a phase,
    in order; raises :class:`GateFailed`."""
    if not group.member:
        return []
    runs = ([lambda: phase_grid(group, device, systems[0].a)]
            if group.size % 2 == 0 else [])
    runs += [lambda s=s: phase_solve(group, device, s) for s in systems]
    lines = []
    for run in runs:
        t0 = time.perf_counter()
        line = run()
        lines.append(f"{line} ({time.perf_counter() - t0:.1f} s)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=multihost.BACKENDS, default="nccl")
    ap.add_argument("--device", default="cuda",
                    help="every rank's device (ranks sharing one card: "
                         "--backend gloo)")
    args = ap.parse_args(argv)
    from tpu_amg_torch.device import resolve_device

    device = resolve_device(args.device)
    multihost.initialize(args.backend)
    import torch.distributed as dist

    if not dist.is_initialized():  # one process with nothing set
        multihost.initialize(args.backend, world_size=1, rank=0,
                             init_method=f"tcp://localhost:"
                                         f"{multihost.free_port()}")
    try:
        world = make_solver_mesh()
        t0 = time.perf_counter()
        systems = build_systems(world, device)
        if world.index == 0:
            print(f"dryrun setups (built side by side, shared): "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in dryrun_multichip(world, device, systems):
            if world.index == 0:
                print(line, flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
