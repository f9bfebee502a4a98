"""Partitioner-only command line with metrics streaming: the port of the JAX
package's ``examples/aggregation.py``.

Equivalent of reference examples/aggregation/main.rs: load or generate a
system, smooth a near-null basis (seeded) with the l1 smoother on the
device (A through K1 + K2, or K3 on a DIA matrix, as an SpMM at k =
``--near-null-dim``), run the modularity partitioner with a callback
that records (and streams, when a viewer listens) per-pass partition
metrics (size cost, edge cost, modularity) and partition assignments,
and dump the final partition, the metrics and the smoothing's
convergence factors to JSON (keys ``node_to_agg``, ``stats``,
``metrics``, ``convergence_factors``, as the JAX example writes them).

The arguments are the JAX example's, with ``--device`` (default "cuda")
added.  The start block is drawn from ``torch.Generator(device)`` seeded
with ``--seed``: another draw than the JAX example's ``jax.random``.
:func:`aggregate` is everything after the smoothing, on a given basis.

Usage: python -m tpu_amg_torch.tools.aggregation [--device cpu] [--n 32] [--out data/aggregation.json]
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--name", type=str, default="system")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--problem", type=str, default="aniso2d")
    p.add_argument("--near-null-dim", type=int, default=8)
    p.add_argument("--smoothing-iters", type=int, default=50)
    p.add_argument("--coarsening-factor", type=float, default=8.0)
    p.add_argument("--improvement-iters", type=int, default=200)
    p.add_argument("--viz-every", type=int, default=5)
    p.add_argument("--out", type=str, default="data/aggregation.json")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the smoothing runs: cuda (the hand-written "
                        "kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    # defaults expected by the shared problem loader (tools.amg)
    for k, v in dict(
        epsilon=1e-3, theta=np.pi / 6, coefficient="constant", block_size=1
    ).items():
        if not hasattr(args, k):
            setattr(args, k, v)
    return args


def smoothed_basis(a, start: torch.Tensor, iterations: int):
    """The l1-smoothed block from ``start`` (n, k) on its device, in
    float64: (basis (n, k) ndarray, convergence factors (k,) ndarray)."""
    from tpu_amg_torch.adaptivity import smooth_vector
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.preconditioners.smoothers import build_smoother

    device = start.device
    op = SparseOperator.from_csr(a, device, torch.float64)
    m = build_smoother("l1", a, device, torch.float64)
    return smooth_vector(op, m, iterations, start.shape[1], x0=start,
                         device=device)


def aggregate(a, basis, cfs, coarsening_factor: float = 8.0,
              improvement_iters: int = 200, viz_every: int = 5,
              client=None, log=None) -> dict:
    """Everything after the smoothing: the strength weights of
    ``basis``, the modularity partitioner whose callback logs the
    metrics of every ``viz_every``-th pass (and streams them and the
    partition to ``client`` when given), and the JSON payload."""
    from tpu_amg_torch.hierarchy import create_weights
    from tpu_amg_torch.partition import PartitionerConfig
    from tpu_amg_torch.utils.viz import PartitionMetrics

    weights = create_weights(a, basis)
    metrics_log = []

    def callback(iteration, partitioner):
        if iteration % viz_every:
            return
        metrics = PartitionMetrics(
            iteration=iteration,
            size_cost=partitioner.total_agg_size_cost(),
            edge_cost=partitioner.total_edge_cost(),
            modularity=partitioner.modularity(),
        )
        metrics_log.append(metrics.to_dict())
        if log is not None:
            log(f"pass {iteration}: modularity={metrics.modularity:.4f} "
                f"edge_cost={metrics.edge_cost:.3e} "
                f"size_cost={metrics.size_cost:.3e} "
                f"{partitioner.partition.info()}")
        if client is not None:
            client.update_partition(partitioner.partition.node_to_agg)
            client.update_metrics(metrics)

    cfg = PartitionerConfig(
        coarsening_factor=coarsening_factor,
        max_improvement_iters=improvement_iters,
        callback=callback,
    )
    part = cfg.build(a, basis, weights).partition
    if log is not None:
        log(f"final: {part.info()}")
    return {
        "node_to_agg": part.node_to_agg.tolist(),
        "stats": dataclasses.asdict(part.info()),
        "metrics": metrics_log,
        "convergence_factors": np.asarray(cfs).tolist(),
    }


def run(argv=None) -> dict:
    """The command line's work; returns the JSON payload it wrote."""
    args = parse_args(argv)
    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.tools.amg import load_problem
    from tpu_amg_torch.utils.viz import VizClient

    device = resolve_device(args.device)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    a, _ = load_problem(args)
    log(f"system: n={a.nrows} nnz={a.nnz}")
    start = torch.randn(
        a.nrows, args.near_null_dim, dtype=torch.float64, device=device,
        generator=torch.Generator(device).manual_seed(args.seed))
    basis, cfs = smoothed_basis(a, start, args.smoothing_iters)

    client = VizClient()
    live = client.health_check()
    if live:
        log("viz server detected; streaming")
    payload = aggregate(a, basis, cfs, args.coarsening_factor,
                        args.improvement_iters, args.viz_every,
                        client if live else None, log)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload))
    print(f"wrote {out}")
    return payload


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
