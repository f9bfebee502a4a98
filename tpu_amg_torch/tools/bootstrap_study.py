"""The float32 bootstrap against the float64 one: what the near-null
bootstrap's dtype does to the setup's time and to the hierarchy's
quality, draw by draw.

For each problem, config seed and bootstrap dtype, ``AMGSolver.setup``
runs from the draws the seed gives (``solver.setup_draws``, the same
blocks for both dtypes) in a worker process of its own (spawned; host
setup is single-threaded, so the setups run side by side), and then:

- ``sa`` (``unstructured_poisson_3d``, ``scalar_3d_config``) and
  ``elasticity`` (``unstructured_elasticity_3d``,
  ``elasticity_3d_config``): PCG of A x = A x_true to rtol 1e-6 for
  each x_true seed (100, 101, 3: ``chip_smoke.py``'s and
  ``tools.solve3d``'s);
- ``adaptive`` (``anisotropic_diffusion_2d(side, random)``, the CLI's
  adaptive defaults with 2 components): PCG of A x = 1 from a seeded x0
  to 1e-12 (the CLI's peel study's first row);

and the ‖E‖_A estimate (100 power steps on 5 vectors).  It prints the
setup's phases, each level's rows, the iterations and ‖E‖_A by seed
and dtype, and the launches by (values, vectors) pair, then one JSON
line.  ``chip_smoke.py`` runs the same jobs (:func:`setup_job`) for its
phases 14, 16 and 17.

Usage: python -m tpu_amg_torch.tools.bootstrap_study [--problems elasticity] [--side 40] [--seeds 0 1 2] [--workers 6] [--device cuda]
"""

import argparse
import json
import sys
import time

import numpy as np

PROBLEMS = ("sa", "elasticity", "adaptive")
BOOTSTRAPS = ("float64", "float32")
RHS_SEEDS = (100, 101, 3)  # x_true seeds: chip_smoke's two, solve3d's
RTOL = 1e-6
MAXITER = 300
ADAPTIVE_COMPONENTS = 2
ADAPTIVE_TOL = 1e-12  # the CLI's --tol
ADAPTIVE_MAXITER = 1000
ADAPTIVE_X0_SEED = 7  # the peel study's x0 in chip_smoke.py


def adaptive_config(device: str, **overrides):
    """The adaptive composite of the CLI's defaults (python -m
    tpu_amg_torch.tools.amg --composite 2): coarsening near-null dim 64,
    interp dim 4, 20 smoothing iterations, the block smoother (block size
    128, 3 steps), coarsening factor 8, 200 aggregation iterations,
    coarsest dim 1000, seed 42, float64."""
    from tpu_amg_torch.solver import SolverConfig

    kw = dict(method="adaptive", composite_components=ADAPTIVE_COMPONENTS,
              coarsening_near_null_dim=64, interp_near_null_dim=4,
              smoothing_iters=20, smoother="block", block_smoother_size=128.0,
              smoothing_steps=3, coarsening_factor=8.0, aggregation_iters=200,
              coarsest_dim=1000, seed=42, device=device)
    kw.update(overrides)
    return SolverConfig(**kw)


def problem(job: dict):
    """(matrix, SolverConfig) of a job: its ``kind`` at ``side``, the
    bootstrap in ``job["bootstrap"]``, the config seed ``job["seed"]``
    when given (else the config's own), on ``job["device"]``."""
    import torch

    from tpu_amg_torch.solver import elasticity_3d_config, scalar_3d_config
    from tpu_amg_torch.utils.problems import (
        anisotropic_diffusion_2d,
        unstructured_elasticity_3d,
        unstructured_poisson_3d,
    )

    kw = dict(bootstrap_dtype=getattr(torch, job["bootstrap"]))
    if job.get("seed") is not None:
        kw["seed"] = job["seed"]
    device, side = job.get("device", "cuda"), job["side"]
    if job["kind"] == "sa":
        return unstructured_poisson_3d(side), scalar_3d_config(device, **kw)
    if job["kind"] == "elasticity":
        return (unstructured_elasticity_3d(side),
                elasticity_3d_config(device, **kw))
    return (anisotropic_diffusion_2d(side, epsilon=1e-3, theta=np.pi / 6,
                                     coefficient="random"),
            adaptive_config(device, **kw))


def reset_launch_counts() -> None:
    from tpu_amg_torch.ops import dia, spmv

    spmv.reset_launch_counts()
    dia.reset_launch_counts()


def launch_tables() -> dict:
    """K1's, K2's and K3's launches since the last reset, by (rows, cols,
    k), by (values, vectors) pair name ("f32f32", ...) and, for K1, by
    design (``spmv.k1_design``), as plain dicts (they cross a process
    boundary)."""
    from tpu_amg_torch.ops import dia, spmv

    short = {"torch.float64": "f64", "torch.float32": "f32",
             "torch.bfloat16": "bf16"}

    def by_dtype(counter):
        return {short[str(v)] + short[str(t)]: n
                for (v, t), n in counter.items()}

    return {
        "K1": dict(by_shape=dict(spmv.csr_spmv_launches_by_shape),
                   by_dtype=by_dtype(spmv.csr_spmv_launches_by_dtype),
                   by_design=dict(spmv.csr_spmv_launches_by_design)),
        "K2": dict(by_shape=dict(spmv.coo_patch_launches_by_shape),
                   by_dtype=by_dtype(spmv.coo_patch_launches_by_dtype)),
        "K3": dict(by_shape=dict(dia.dia_spmv_launches_by_shape),
                   by_dtype=by_dtype(dia.dia_spmv_launches_by_dtype)),
    }


def setup_job(job: dict) -> dict:
    """One setup and its solves (run in a worker process): the launch
    counts set to 0 just before the setup and read just after it; the
    checkpoint saved when ``job["ckpt"]`` names one (and then no solve),
    with the preconditioner's apply on the standard normal vector of
    ``job["probe_seed"]`` where one is given (a loaded checkpoint is
    held to it); else the solves and ‖E‖_A of the module docstring.
    Returns the job with what it measured."""
    import torch

    from tpu_amg_torch.solver import AMGSolver, setup_draws
    from tpu_amg_torch.utils.testing import (
        approx_convergence_factor,
        test_solver,
    )

    a, cfg = problem(job)
    starts, blocks = setup_draws(a.nrows, cfg)
    dev = torch.device(cfg.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sync()
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, cfg, near_null_starts=starts,
                             enrichment_starts=blocks)
    sync()
    out = dict(job, setup_s=time.perf_counter() - t0,
               seconds=dict(solver.setup_seconds), counts=launch_tables(),
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                        else None),
               rows=[[m.nrows for m in h.matrices] for h in (
                   solver.component_hierarchies or [solver.hierarchy])])
    if job.get("ckpt"):
        t0 = time.perf_counter()
        solver.save(job["ckpt"])
        out["save_s"] = time.perf_counter() - t0
        if job.get("probe_seed") is not None:
            r = np.random.default_rng(job["probe_seed"]).standard_normal(
                a.nrows)
            out["probe"] = solver.apply_preconditioner(
                torch.from_numpy(r).to(dev)).cpu().numpy()
        return out
    iters, rel_res, converged = [], [], True
    if job["kind"] == "adaptive":
        pc = solver.preconditioner
        rhs = torch.ones(a.nrows, dtype=torch.float64, device=dev)
        x0 = torch.randn(a.nrows, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(
                             ADAPTIVE_X0_SEED)).to(dev)
        report = test_solver(pc.a, pc, rhs, x0, rtol=ADAPTIVE_TOL,
                             maxiter=ADAPTIVE_MAXITER, run_sli=False)
        iters.append(report.cg_iters)
        rel_res.append(float(report.cg_history[-1]
                             / torch.linalg.vector_norm(rhs)))
        converged = report.cg_converged
        e_norm = approx_convergence_factor(pc.a, pc)
    else:
        for seed in job.get("rhs_seeds", RHS_SEEDS):
            x_true = np.random.default_rng(seed).standard_normal(a.nrows)
            b = solver.op.mv(torch.from_numpy(x_true).to(dev))
            x, info = solver.solve(b, rtol=RTOL, maxiter=MAXITER)
            iters.append(info.iters)
            converged = converged and info.converged
            rel_res.append(float(torch.linalg.vector_norm(
                b - solver.op.mv(x)) / torch.linalg.vector_norm(b)))
        e_norm = approx_convergence_factor(solver.op, solver.preconditioner)
    sync()
    out.update(iters=iters, rel_res=rel_res, converged=converged,
               e_norm=e_norm)
    return out


def start_jobs(jobs: dict, workers: int):
    """Each job on a pool of ``workers`` spawned processes: (pool,
    {name: AsyncResult}).  The caller reads every result and terminates
    the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(workers)
    return pool, {name: pool.apply_async(setup_job, (job,))
                  for name, job in jobs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", nargs="+", choices=PROBLEMS,
                    default=["elasticity"])
    ap.add_argument("--side", type=int, nargs="+", default=None,
                    help="mesh side, one a problem (default: sa 48, "
                         "elasticity 40, adaptive 512)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="config seeds: the draws of each setup (the "
                         "adaptive config's own is 42)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device

    resolve_device(args.device)
    defaults = {"sa": 48, "elasticity": 40, "adaptive": 512}
    sides = args.side or [defaults[p] for p in args.problems]
    if len(sides) != len(args.problems):
        raise SystemExit("--side takes one side a problem")
    jobs = {}
    for kind, side in zip(args.problems, sides):
        for seed in args.seeds:
            for boot in BOOTSTRAPS:
                jobs[(kind, seed, boot)] = dict(
                    kind=kind, side=side, seed=seed, bootstrap=boot,
                    device=args.device)
    pool, results = start_jobs(jobs, args.workers)
    try:
        out = [results[key].get() for key in jobs]
    finally:
        pool.terminate()
        pool.join()
    for r in out:
        print(f"{r['kind']} side {r['side']} seed {r['seed']} bootstrap "
              f"{r['bootstrap']}: setup {r['setup_s']:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in r["seconds"].items())
              + "); rows " + "; ".join(" / ".join(map(str, rows))
                                       for rows in r["rows"])
              + f"; PCG iterations {r['iters']} (converged "
              f"{r['converged']}), ||E||_A {r['e_norm']:.6f}; launches by "
              f"(values, vectors): " + ", ".join(
                  f"{k} {t['by_dtype']}" for k, t in r["counts"].items()),
              flush=True)
    print(json.dumps([{k: v for k, v in r.items() if k != "counts"}
                      for r in out]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
