"""The ranks of tests/test_torch_multihost.py (the port of
tests/multihost_worker.py), one process a rank, the port alone:

    python -m tests.torch_multihost_worker

Started by ``tpu_amg_torch.parallel.multihost.launch`` as 4 gloo ranks
on the CPU.  The ranks play 2 nodes of 2 ranks each, the node of rank r
being r % 2, so that the pod mesh has to reorder them (row order 0, 2,
1, 3); the halo PCG on that order prints each rank's deviation from the
single-process solution.  Then the multi-rank dry run
(``tools.dryrun_multichip``) on the first 4 and the first 2 ranks, and
its padded PCG on a system the 4 ranks do not divide.  With
``fail-rank R`` rank R exits with an error before it joins the group,
and the others block there until the launcher stops them.
"""

import sys

import numpy as np
import scipy.sparse.linalg as spla
import torch
import torch.distributed as dist

from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.parallel import multihost
from tpu_amg_torch.parallel.dist import (make_solver_mesh, set_group,
                                         shard_vector, try_shard_halo)
from tpu_amg_torch.shard_utils import all_gather_rows
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.tools import dryrun_multichip
from tpu_amg_torch.utils.problems import poisson2d


def dist_rank() -> int:
    import os

    return int(os.environ["RANK"])


def main() -> None:
    multihost.initialize("gloo")
    rank = dist.get_rank()
    pod = multihost.pod_mesh(node_key=f"node{rank % 2}")
    assert pod.grid.tolist() == [[0, 2], [1, 3]], pod.grid
    a = poisson2d(16)  # 256 dofs over 4 ranks
    x_ref = spla.spsolve(a.to_scipy().tocsc(), np.ones(a.nrows))
    # the CSR form (K1 + K2 on the card), as the JAX worker takes ELL
    h = try_shard_halo(CappedCSR.from_csr(a, "cpu"), pod.group)
    assert h is not None, "the halo path must engage"
    with set_group(pod.group):
        x, info = cg(h, shard_vector(torch.ones(a.nrows, dtype=torch.float64),
                                     pod.group), rtol=1e-10)
        x = all_gather_rows(x, pod.group).numpy()
    err = float(np.max(np.abs(x - x_ref)))
    print(f"MULTIHOST p{rank}: converged={info.converged} iters={info.iters} "
          f"row block {pod.group.index} ({type(h).__name__}, halo {h.halo}) "
          f"err={err:.2e}", flush=True)
    assert info.converged and err < 1e-7

    world = make_solver_mesh()
    systems = dryrun_multichip.build_systems(world, "cpu")
    for width in (4, 2):
        group = make_solver_mesh(width)
        for line in dryrun_multichip.dryrun_multichip(group, "cpu", systems):
            if group.index == 0:
                print(f"[{width}] {line}", flush=True)
    # a system the ranks do not divide: padded with identity rows, its
    # multigrid run replicated behind the boundary
    a = poisson2d(15)  # 225 rows over 4 ranks: 228
    mg = dryrun_multichip.sa_setup(a, np.ones((a.nrows, 1)), 1, 4.0, 20, 3,
                                   "cholesky", torch.float64, "cpu")
    run = dryrun_multichip.sharded_pcg(
        a, mg, world, np.ones(a.nrows), torch.float64, "cpu", 1e-10)
    print(f"PADDED p{rank}: n={a.nrows} over {world.size} ranks, fine="
          f"{type(run.fine).__name__}, {run.info.iters} iterations, "
          f"sharded==single rel err {run.rel_err:.1e}", flush=True)
    multihost.shutdown()


if __name__ == "__main__":
    if sys.argv[1:2] == ["fail-rank"]:  # a rank that fails before joining
        if dist_rank() == int(sys.argv[2]):
            raise SystemExit(f"rank {sys.argv[2]} fails on purpose")
        multihost.initialize("gloo")  # blocks: the launcher stops it
    main()
