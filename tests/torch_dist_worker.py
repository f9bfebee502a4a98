"""The port's side of tests/test_torch_distributed.py, one process a rank.

Started by ``tpu_amg_torch.parallel.multihost.launch`` (torchrun's
environment, gloo, the CPU); imports the port alone, never jax:

    python -m tests.torch_dist_worker <dir>

``<dir>/inputs.npz`` and ``<dir>/hierarchy.npz`` (the JAX package's
hierarchy archive, with its Chebyshev start vectors in ``<dir>/lam.npz``)
come from the test.  For each width w of the world (its first 1, 2, 4
and 8 ranks), every check runs, and rank 0 writes ``<dir>/port.npz``:
each halo case's y (as a ``HaloCSR`` and as a ``HaloELL``), the sharded
PCG's x and iteration count, the padded ELL system's PCG through
``HaloELL`` and through ``shard_ell`` (w = 2 and 4), the scaling sweep's
record and, for the solver group of one rank, whether the sharded solve
equals the unsharded one bit for bit.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tpu_amg_torch.linop import DiagonalOperator, SparseOperator
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.parallel import multihost
from tpu_amg_torch.parallel.dist import (make_solver_mesh, pad_ell_identity,
                                         replicate, set_group, shard_ell,
                                         shard_vector, solve_sharded)
from tpu_amg_torch.parallel.halo import HaloCSR, HaloDIA, HaloELL
from tpu_amg_torch.partition import PartitionerConfig
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.preconditioners.smoothers import l1_inverse_diag
from tpu_amg_torch.shard_utils import all_gather_rows
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.sparse.ell import ELL
from tpu_amg_torch.tools import bench_scaling
from tpu_amg_torch.utils import checkpoint

# the cases' CSR arrays in inputs.npz: <name>_data, _indices, _indptr,
# _shape; x_<name> the vector or block they multiply
HALO_CASES = ("poisson2d", "unstructured2d", "poisson2d_mm", "transfer",
              "poisson3d_dia")
REPLICATE_BELOW = 200
# the ELL system (poisson2d(15), 225 rows): padded to a multiple of w by
# pad_ell_identity, solved sharded over the first w ranks
ELL_SYSTEM = "ellsys"
ELL_WIDTHS = (2, 4)
PCG_RTOL = 1e-10
SWEEP = dict(rows_per_rank=512, strip=32, reps=1, pcg_iters=2)


def load_csr(z, name) -> CSR:
    return CSR(data=z[f"{name}_data"], indices=z[f"{name}_indices"],
               indptr=z[f"{name}_indptr"], shape=tuple(z[f"{name}_shape"]))


def halo_form(name, csr, group):
    if name == "poisson3d_dia":
        return HaloDIA.from_dia(DIA.from_csr(csr, "cpu"), group)
    return HaloCSR.from_csr(csr, group, "cpu")


def ell_system_solves(csr: CSR, group) -> dict:
    """PCG of the padded ELL system (``b`` ones, the l1 smoother's
    diagonal as M) sharded over ``group``: through ``HaloELL``
    (``solve_sharded``) and through ``shard_ell``'s all-gather form."""
    w = group.size
    ell = pad_ell_identity(ELL.from_csr(csr, "cpu"), w)
    d = l1_inverse_diag(ell)
    b = torch.ones(ell.nrows, dtype=torch.float64)
    run = solve_sharded(SparseOperator(mat=ell), DiagonalOperator(d), b,
                        group, rtol=PCG_RTOL)
    with set_group(group):
        x, info = cg(shard_ell(ell, group, "cpu"), shard_vector(b, group),
                     DiagonalOperator(shard_vector(d, group)), rtol=PCG_RTOL)
        x = all_gather_rows(x, group)
    return {f"ell_halo_x_{w}": run.x.numpy(),
            f"ell_halo_iters_{w}": run.info.iters,
            f"ell_halo_fine_{w}": type(run.fine).__name__,
            f"ell_halo_{w}": run.fine.halo,
            f"ell_gather_x_{w}": x.numpy(), f"ell_gather_iters_{w}": info.iters,
            f"ell_rows_{w}": ell.nrows}


def multigrid(directory: Path):
    """The mixed cycle of the test: level 0's block smoother, Chebyshev
    below it (from the JAX package's start vectors), the banded coarse
    solve; the same cycle built twice, as the JAX side builds it."""
    h = checkpoint.load_hierarchy(directory / "hierarchy.npz")
    with np.load(directory / "lam.npz") as z:
        lam = [z[f"l{i}"] for i in range(len(z.files))]
    built = {
        kind: MultigridConfig(
            smoothing_steps=1, smoother=kind, coarse_solver="banded",
            dense_threshold=0, device="cpu",
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=16.0, max_improvement_iters=5),
        ).build(h, lam)
        for kind in ("chebyshev", "block")}
    mg = built["chebyshev"]
    return h, dataclasses.replace(
        mg, levels=(built["block"].levels[0],) + mg.levels[1:])


def main(directory: str) -> None:
    directory = Path(directory)
    multihost.initialize("gloo")
    out, records = {}, []
    z = np.load(directory / "inputs.npz")
    world = make_solver_mesh()
    h, mg = replicate(multigrid(directory) if world.index == 0 else None,
                      world)
    a0 = h.matrices[0]
    b = torch.ones(a0.nrows, dtype=torch.float64)
    for w in (1, 2, 4, 8):
        group = make_solver_mesh(w)
        if not group.member:
            continue
        for name in HALO_CASES:
            csr = load_csr(z, name.removesuffix("_mm"))
            x = torch.from_numpy(z[f"x_{name}"])
            hop = halo_form(name, csr, group)
            y = all_gather_rows(hop.mv(shard_vector(x, group)) if x.dim() == 1
                                else hop.mm(shard_vector(x, group)), group)
            out[f"y_{name}_{w}"] = y.numpy()
            out[f"halo_{name}_{w}"] = hop.halo
            if name != "poisson3d_dia":  # the same block as a HaloELL
                hop = HaloELL.from_ell(ELL.from_csr(csr, "cpu"), group)
                xs = shard_vector(x, group)
                out[f"y_ell_{name}_{w}"] = all_gather_rows(
                    hop.mv(xs) if x.dim() == 1 else hop.mm(xs), group).numpy()
                out[f"halo_ell_{name}_{w}"] = hop.halo
        if w in ELL_WIDTHS:
            out.update(ell_system_solves(load_csr(z, ELL_SYSTEM), group))
        if w < 8:  # the JAX side holds 2 and 4; 1 is held bitwise
            run = solve_sharded(SparseOperator.from_csr(a0, "cpu"), mg, b,
                                group, rtol=PCG_RTOL,
                                replicate_below=REPLICATE_BELOW)
            out[f"pcg_x_{w}"] = run.x.numpy()
            out[f"pcg_iters_{w}"] = run.info.iters
            out[f"pcg_forms_{w}"] = json.dumps(run.forms)
        if w == 1:
            # the unsharded port on the same inputs, bit for bit
            out["w1_pcg_bitwise"] = bool(
                run.bitwise
                and run.info.res_norms == run.info_one.res_norms)
            csr = load_csr(z, "unstructured2d")
            xv = torch.from_numpy(z["x_unstructured2d"])
            out["w1_spmv_bitwise"] = bool(torch.equal(
                halo_form("unstructured2d", csr, group).mv(xv),
                SparseOperator(mat=CappedCSR.from_csr(csr, "cpu")).mv(xv)))
        records.append(bench_scaling.width_record(group, torch.device("cpu"),
                                                  **SWEEP))
    if dist.get_rank() == 0:
        out["sweep"] = json.dumps(records)  # row block 0's records
        np.savez(directory / "port.npz", **out)
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
