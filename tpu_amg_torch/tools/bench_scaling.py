"""Weak-scaling harness: the sharded halo SpMV and PCG over 1 → N ranks.

Port of ``bench_scaling.py``.  The rows a rank holds stay fixed while the
ranks grow 1, 2, 4, ... N (the first w ranks of one launch, for each
width w).  The problem is a 5-point Poisson strip, ``poisson2d(length,
width)``, whose length grows with the ranks: each rank owns a slab of
``rows_per_rank`` rows and its boundary with the next slab is one grid
line of ``width`` nodes, whatever the number of ranks (the surface of a
1-D row partition, not its volume).  One JSON line a width:

- ``nnz_per_shard``: each rank's stored entries of A (``HaloCSR``);
- ``halo``, ``bytes_per_boundary`` and ``bytes_per_spmv``: the ring
  exchange's rows and the bytes that cross between ranks in one float64
  SpMV, at one boundary and in all;
- ``spmv_ms``: the sharded SpMV's time on the slowest rank (host clock
  around ``REPS`` calls, synchronised), K1 + K2 per rank on the card;
- ``pcg_ms_per_iteration``: PCG preconditioned by the sharded V-cycle
  (``shard_multigrid`` of an SA hierarchy, rtol 0, ``PCG_ITERS``
  iterations; ``parallel.dist.solve_sharded``), on the slowest rank;
- ``spmv_equal`` / ``spmv_max_rel_err`` and ``pcg_rel_err``: the
  sharded results against one rank's on the same inputs (VERDICT.md:
  247-251).

Ranks that share one card, or CPU ranks, share its bandwidth and cores:
their efficiency is no multi-chip efficiency, and the output says so.

    python -m tpu_amg_torch.tools.bench_scaling --ranks 8 --backend gloo \\
        --device cpu --rows-per-rank 4096
    torchrun --nproc-per-node 8 -m tpu_amg_torch.tools.bench_scaling ...

Run without a launcher it starts its ranks itself
(``parallel.multihost.launch``) and prints rank 0's lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

CAVEAT = ("# weak-scaling efficiency t_1 / t_N here is that of ranks "
          "sharing one host{}: no multi-chip efficiency")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _gather(values, group, device) -> list:
    """Every rank's ``values`` (a list of numbers), in row-block order."""
    from tpu_amg_torch.shard_utils import all_gather_rows

    t = torch.tensor([values], dtype=torch.float64, device=device)
    return all_gather_rows(t, group).tolist()


REPS = 30  # SpMV calls timed a width
PCG_ITERS = 10  # PCG iterations timed a width (rtol 0)
STRIP = 256  # the strip's width: the rows at one boundary
TIMEOUT = 1800  # seconds the launched ranks may take


def width_record(group, device, rows_per_rank: int, strip: int = STRIP,
                 reps: int = REPS, pcg_iters: int = PCG_ITERS) -> dict:
    """One width's line (on row block 0; the other ranks return None)."""
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops.spmv import CappedCSR, spmv
    from tpu_amg_torch.parallel.dist import (replicate, shard_vector,
                                             solve_sharded)
    from tpu_amg_torch.parallel.halo import HaloCSR, exchange_bytes
    from tpu_amg_torch.shard_utils import all_gather_rows
    from tpu_amg_torch.utils.problems import poisson2d

    w = group.size
    n = rows_per_rank * w
    a = poisson2d(n // strip, strip)
    dt = torch.float64
    h = HaloCSR.from_csr(a, group, device, dt)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=dt)
    y = all_gather_rows(h.mv(shard_vector(x, group, device)), group)
    y_one = spmv(CappedCSR.from_csr(a, device, dt), x.to(device))
    spmv_err = float((y - y_one).abs().max() / y_one.abs().max())
    nnz = [int(v[0]) for v in _gather([h.local.nnz], group, device)]
    x_loc = shard_vector(x, group, device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        h.mv(x_loc)
    _sync(device)
    spmv_s = max(v[0] for v in _gather(
        [(time.perf_counter() - t0) / reps], group, device))

    mg = replicate(_sa_multigrid(a, device) if group.index == 0 else None,
                   group)
    pcg = solve_sharded(SparseOperator.from_csr(a, device, dt), mg,
                        torch.ones(n, dtype=dt, device=device), group,
                        rtol=0.0, maxiter=pcg_iters, replicate_below=4096)
    pcg_s = max(v[0] for v in _gather([pcg.seconds / pcg_iters], group,
                                      device))
    if group.index != 0:
        return None
    return {
        "ranks": w, "n": n, "grid": [n // strip, strip],
        "rows_per_rank": rows_per_rank, "device": str(device),
        "halo": h.halo, "nnz_per_shard": nnz,
        "bytes_per_boundary": (exchange_bytes(h.halo, group, 1, dt)
                               // (w - 1) if w > 1 else 0),
        "bytes_per_spmv": exchange_bytes(h.halo, group, 1, dt),
        "spmv_ms": spmv_s * 1e3, "spmv_equal": bool(torch.equal(y, y_one)),
        "spmv_max_rel_err": spmv_err,
        "levels": pcg.forms, "pcg_iterations": pcg_iters,
        "pcg_ms_per_iteration": pcg_s * 1e3, "pcg_rel_err": pcg.rel_err,
    }


def _sa_multigrid(a, device):
    """The JAX harness's solver: an SA hierarchy (cd 1, cf 8, coarsest
    256, 4 levels) and the default multigrid with 1 smoothing step."""
    from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
    from tpu_amg_torch.interpolation import (AggregationConfig,
                                             InterpolationConfig)
    from tpu_amg_torch.partition import PartitionerConfig
    from tpu_amg_torch.preconditioners.multigrid_builder import (
        MultigridConfig)

    nn = np.ones((a.nrows, 1))
    h = HierarchyConfig(
        coarsest_dim=256, max_levels=4, device=device,
        interpolation_config=InterpolationConfig(
            kind="aggregation", aggregation=AggregationConfig(
                candidate_dimension=1, partitioner_config=PartitionerConfig(
                    coarsening_factor=8.0, max_improvement_iters=5))),
    ).build(a, nn, create_weights(a, nn))
    return MultigridConfig(smoothing_steps=1, device=device).build(h)


def widths(n_ranks: int) -> list:
    """1, 2, 4, ... up to ``n_ranks`` (and ``n_ranks`` itself)."""
    out, w = [], 1
    while w < n_ranks:
        out.append(w)
        w *= 2
    return out + [n_ranks]


def run_ranks(args) -> None:
    """This process's part of every width (a rank of a launched world)."""
    import torch.distributed as dist

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.parallel import multihost
    from tpu_amg_torch.parallel.dist import make_solver_mesh

    device = resolve_device(args.device)
    multihost.initialize(args.backend)
    try:
        records = []
        for w in widths(dist.get_world_size()):
            group = make_solver_mesh(w)
            if not group.member:
                continue
            rec = width_record(group, device, args.rows_per_rank)
            if rec is not None:
                if records:
                    rec["spmv_efficiency"] = records[0]["spmv_ms"] / rec[
                        "spmv_ms"]
                records.append(rec)
                print(json.dumps(rec), flush=True)
        if dist.get_rank() == 0:
            shared = ("" if device.type == "cpu"
                      else f" and one card ({torch.cuda.get_device_name()})")
            print(CAVEAT.format(shared), flush=True)
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks to start when run without a launcher")
    ap.add_argument("--backend", default="gloo", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-rank", type=int, default=65_536)
    args = ap.parse_args(argv)
    if args.rows_per_rank % STRIP:
        ap.error(f"--rows-per-rank must be a multiple of {STRIP}")
    from tpu_amg_torch.device import resolve_device

    resolve_device(args.device)  # no card: fail here, not in every rank
    if "WORLD_SIZE" in os.environ:
        run_ranks(args)
        return 0
    from tpu_amg_torch.ops import native
    from tpu_amg_torch.parallel.multihost import launch

    native.lib()  # the host library, built once here, not by every rank
    argv = sys.argv[1:] if argv is None else list(argv)
    print(launch("tpu_amg_torch.tools.bench_scaling", argv, args.ranks,
                 TIMEOUT)[0], end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
