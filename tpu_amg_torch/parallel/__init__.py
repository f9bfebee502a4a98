"""Distribution over ``torch.distributed``: one rank a shard.

Port of ``tpu_amg/parallel``.  Each level's matrix is row-partitioned
over the ranks of a solver group, vectors hold each rank's rows, and
the collectives XLA inserts for the JAX package are written out: the
halo slabs' point-to-point exchange (:mod:`.halo`), the all-gather at
the shard/replicate boundary and the sharded block smoother's
all-reduce (:mod:`.dist`), the dot products' all-reduce
(:mod:`tpu_amg_torch.shard_utils`).  :mod:`.multihost` starts and joins
the processes; :func:`.dist.solve_sharded` is the one function that shards
a solve and holds it against one rank.
"""

from tpu_amg_torch.parallel.dist import (
    ShardedSolve,
    make_solver_mesh,
    pad_csr_identity,
    pad_ell_identity,
    replicate,
    set_group,
    shard_csr,
    shard_ell,
    shard_multigrid,
    shard_operator,
    solve_sharded,
    try_shard_halo,
)
from tpu_amg_torch.parallel.halo import HaloCSR, HaloDIA, HaloELL, halo_spmv

__all__ = [
    "make_solver_mesh",
    "pad_csr_identity",
    "pad_ell_identity",
    "shard_csr",
    "shard_ell",
    "shard_operator",
    "shard_multigrid",
    "replicate",
    "set_group",
    "try_shard_halo",
    "solve_sharded",
    "ShardedSolve",
    "HaloCSR",
    "HaloDIA",
    "HaloELL",
    "halo_spmv",
]
