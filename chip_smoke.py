"""Drive the PyTorch/CUDA port (tpu_amg_torch) once on one GPU and check it.

Usage: python3 chip_smoke.py [--side 64] [--reps 50]

Phases, one printed line per result; any failed check exits non-zero:
  1. device: nvidia-smi's name and power limit, torch / CUDA / nvcc / g++;
  2. builds: the CUDA kernels (nvcc) and the native host library (g++),
     from the sources in this checkout;
  3. kernels vs their plain PyTorch versions on the card: a random
     heavy-row matrix with a small cap, then the level-0 A, P and R of the
     main path's hierarchy; mv and mm (k=8, and for A the bootstrap's
     k=7), float64 and float32; errors, and the device's time per call:
     CUDA events around the replay of a CUDA graph of 50 calls (median of
     5 replays);
  4. main path: AMGSolver.setup on unstructured_poisson_3d(side) with the
     scalar 3-D SA config, then 3 PCG solves of A x = A x_true (seeded
     x_true) to rtol 1e-6; the kernels' launch counts over that run must
     be > 0; the V-cycle's time as the solve runs it (enqueued from
     Python) and the device's own time for it (graph replays);
  5. a small input solved on the card and, from the same hierarchy, on
     the CPU through the plain versions: the two must agree.
Phase 3 runs in two parts: the heavy-row matrix before the main path,
the level-0 operators after it (they come from its hierarchy).  Launch
counts are read before those comparison launches.
The last two lines are a JSON object of per-kernel results and the
device line.  With no CUDA device it exits with code 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

RTOL = 1e-6
MAX_ITERS = 46  # twice the reference's 23 PCG iterations for this config
TOL = {"float64": 1e-12, "float32": 1e-5}  # f64: atomics reorder sums


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    say(("ok    " if ok else "FAIL  ") + msg)
    if not ok:
        sys.exit(1)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def median_ms(fn, reps: int, runs: int = 5, graph: bool = False) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls, divided
    by ``reps``; the median of ``runs`` such runs.

    Eager (``graph=False``) the calls are enqueued from Python back to
    back: for work shorter than the host's cost of enqueuing it this is
    the host's rate, which is what an eager caller pays.  With
    ``graph=True`` the ``reps`` calls are captured once into a CUDA graph
    and the replays are timed: the device's own time, without the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run_once = g.replay
    else:
        def run_once():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_once()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def smoke_config(device: str, **overrides):
    import torch

    from tpu_amg_torch.solver import SolverConfig

    # the scalar 3-D config of tools/setup3d.py, in float64
    kw = dict(
        coarsening_near_null_dim=8, interp_near_null_dim=2,
        coarsening_factor=16.0, smoothing_steps=1, smoothing_iters=10,
        coarsest_dim=1500, dense_threshold=8192, sa_trunc_tol=0.1,
        coarse_drop_tol=0.01, dtype=torch.float64, device=device,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def heavy_row_matrix(seed: int = 0):
    """Random rectangular CSR with rows of 1-120 entries and duplicates
    summed: with cap 16 most rows spill to the tail."""
    from tpu_amg_torch.sparse.csr import CSR

    rng = np.random.default_rng(seed)
    n, m = 20000, 15000
    deg = rng.integers(1, 121, n)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, len(rows))
    return CSR.from_coo(rows, cols, rng.standard_normal(len(rows)), (n, m))


def kernel_cases(name, mat_by_dtype, reps, results, ks=(1, 8)):
    """Compare K1, K2 and K1+K2 with the plain versions on one matrix;
    time each on the device (CUDA graph replays)."""
    import torch

    from tpu_amg_torch.ops import spmv

    for dtype, mat in mat_by_dtype.items():
        dname = str(dtype).replace("torch.", "")
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            y1 = spmv.csr_spmv_capped(mat, x)
            p1 = spmv.plain_csr_spmv_capped(mat, x)
            y2 = torch.zeros_like(y1)
            p2 = torch.zeros_like(y1)
            spmv.coo_patch(mat, x, y2)
            spmv.plain_coo_patch(mat, x, p2)
            y = y1 + y2
            p = p1 + p2
            torch.cuda.synchronize()
            scale = float(p.abs().max())
            rel = float((y - p).abs().max()) / max(scale, 1e-300)
            err1 = float((y1 - p1).abs().max())
            err2 = float((y2 - p2).abs().max())
            t1 = median_ms(lambda: spmv.csr_spmv_capped(mat, x), reps,
                           graph=True)
            t1p = median_ms(lambda: spmv.plain_csr_spmv_capped(mat, x), reps,
                            graph=True)
            t2 = t2p = float("nan")  # K2 launches only for a tail
            if mat.n_tail:
                yz = torch.zeros_like(y1)
                t2 = median_ms(lambda: spmv.coo_patch(mat, x, yz), reps,
                               graph=True)
                t2p = median_ms(lambda: spmv.plain_coo_patch(mat, x, yz),
                                reps, graph=True)
            check(
                rel <= TOL[dname],
                f"kernels {name} {dname} k={k}: shape {mat.shape} "
                f"nnz {mat.nnz} tail {mat.n_tail} group {mat.group}: "
                f"max rel err {rel:.3e} (limit {TOL[dname]:.0e}); "
                f"K1 {t1:.4f} ms plain {t1p:.4f} ms; "
                f"K2 {t2:.4f} ms plain {t2p:.4f} ms",
            )
            results.append(dict(case=name, dtype=dname, k=k, err1=err1,
                                err2=err2, k1_ms=t1, k1_plain_ms=t1p,
                                k2_ms=t2, k2_plain_ms=t2p,
                                n_tail=mat.n_tail))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=64,
                    help="mesh side: side**3 dofs (64: 262,144; 101: 1.03M)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2

    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.ops import _build, native, spmv
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.utils.problems import unstructured_poisson_3d

    # ---- 1. device
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; "
        f"nvcc {run([spmv.nvcc_path(), '--version']).splitlines()[-1]}; "
        f"g++ {run(['g++', '-dumpfullversion'])}")

    # ---- 2. builds, from this checkout's sources
    for lib_name in ("libamg_kernels.so", "libamg_native.so"):
        (_build.BUILD_DIR / lib_name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    spmv.kernel_lib()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    t_n = time.perf_counter() - t0
    say(f"build: libamg_kernels.so (nvcc, sm_90a) {t_k:.1f} s; "
        f"libamg_native.so (g++) {t_n:.1f} s")

    # ---- 3a. kernels vs plain on a heavy-row matrix with a small cap
    results = []
    heavy = heavy_row_matrix()
    kernel_cases(
        "heavy-row cap 16",
        {dt: spmv.CappedCSR.from_csr(heavy, "cuda", dt, cap=16)
         for dt in (torch.float64, torch.float32)},
        args.reps, results,
    )

    # ---- 4. main path
    t0 = time.perf_counter()
    a = unstructured_poisson_3d(args.side)
    say(f"problem: unstructured_poisson_3d({args.side}): n={a.nrows} "
        f"nnz={a.nnz} built in {time.perf_counter() - t0:.1f} s")
    cfg = smoke_config("cuda")
    torch.cuda.synchronize()
    spmv.reset_launch_counts()
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, cfg)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_counts = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    h = solver.hierarchy
    phases = " ".join(f"{k} {v:.1f} s" for k, v in solver.setup_seconds.items())
    say(f"setup: {t_setup:.1f} s ({phases}); levels {h.num_levels}; "
        f"op complexity {h.op_complexity():.3f}; "
        f"grid complexity {h.grid_complexity():.3f}")
    for lvl, m in enumerate(h.matrices):
        say(f"  level {lvl}: n={m.nrows} nnz={m.nnz} "
            f"({m.nnz / m.nrows:.1f}/row)")
    a_mat = solver.op.mat
    solve_s = []
    for i in range(3):
        # b = A x_true for a seeded x_true, the reference's own protocol
        # (tools/solve3d.py:87-90)
        x_true = np.random.default_rng(100 + i).standard_normal(a.nrows)
        b = spmv.plain_spmv(a_mat, torch.from_numpy(x_true).cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b, rtol=RTOL, maxiter=200)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        true_rel = float(torch.linalg.vector_norm(b - spmv.plain_spmv(a_mat, x))
                         / torch.linalg.vector_norm(b))
        check(
            info.converged and info.iters <= MAX_ITERS
            and np.isfinite(true_rel) and true_rel <= 1.01 * RTOL
            and tuple(x.shape) == (a.nrows,),
            f"solve {i}: {solve_s[-1]:.3f} s, {info.iters} iterations "
            f"(limit {MAX_ITERS}), true relative residual {true_rel:.3e} "
            f"(limit {1.01 * RTOL:.3e})",
        )
    torch.cuda.synchronize()
    launches = (spmv.csr_spmv_launches, spmv.coo_patch_launches)
    solve_counts = (launches[0] - setup_counts[0],
                    launches[1] - setup_counts[1])
    check(
        min(solve_counts) > 0 and min(launches) > 0,
        f"launches over the main path: csr_spmv_capped {launches[0]} "
        f"(solves {solve_counts[0]}), coo_patch {launches[1]} "
        f"(solves {solve_counts[1]})",
    )
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(a.nrows)).cuda()
    t_vc = median_ms(lambda: solver.apply_preconditioner(r), 20)
    t_vc_dev = median_ms(lambda: solver.apply_preconditioner(r), 20,
                         graph=True)
    say(f"V-cycle: {t_vc:.3f} ms as the solve runs it (enqueued from "
        f"Python), {t_vc_dev:.3f} ms on the device (CUDA graph replay); "
        f"solves " + ", ".join(f"{s:.3f}" for s in solve_s) + " s")

    # ---- 3b. kernels vs plain at the main path's level-0 shapes
    lvl0 = solver.preconditioner.levels[0]
    k_boot = cfg.coarsening_near_null_dim - 1  # the bootstrap's block width
    for name, op, csr, ks in (
        ("A0", lvl0.a, h.matrices[0], (1, k_boot, 8)),
        ("P0", lvl0.p, h.interpolations[0], (1, 8)),
        ("R0", lvl0.r, h.restrictions[0], (1, 8)),
    ):
        kernel_cases(
            name,
            {torch.float64: op.mat,
             torch.float32: spmv.CappedCSR.from_csr(csr, "cuda",
                                                    torch.float32)},
            args.reps, results, ks,
        )

    # ---- 5. small input: card vs the plain versions on the CPU
    small = unstructured_poisson_3d(16)
    scfg = smoke_config("cuda", coarsest_dim=100, dense_threshold=200)
    s_gpu = AMGSolver.setup(small, scfg)
    mg_cpu = MultigridConfig(
        smoother=scfg.smoother, smoothing_steps=scfg.smoothing_steps,
        dense_threshold=scfg.dense_threshold, device="cpu",
    ).build(s_gpu.hierarchy)
    op_cpu = SparseOperator.from_csr(small, "cpu")
    b_np = np.random.default_rng(3).standard_normal(small.nrows)
    xg, ig = s_gpu.solve(b_np, rtol=RTOL)
    xc, ic = cg(op_cpu, torch.from_numpy(b_np), mg_cpu, rtol=RTOL)
    dx = float((xg.cpu() - xc).abs().max() / xc.abs().max())
    zg = s_gpu.apply_preconditioner(b_np).cpu()
    zc = mg_cpu.mv(torch.from_numpy(b_np))
    dz = float((zg - zc).abs().max() / zc.abs().max())
    check(
        ig.converged and ig.iters == ic.iters and dz <= 1e-10 and dx <= 1e-6,
        f"small input n={small.nrows}, {s_gpu.hierarchy.num_levels} levels: "
        f"card {ig.iters} / CPU {ic.iters} iterations; V-cycle rel diff "
        f"{dz:.2e} (limit 1e-10); solution rel diff {dx:.2e} (limit 1e-6)",
    )

    # ---- results
    # the main path runs float64: its errors and times go in the record
    main_cases = [c for c in results if c["case"] in ("A0", "P0", "R0")
                  and c["dtype"] == "float64"]
    a0 = next(c for c in main_cases if c["case"] == "A0" and c["k"] == 1)
    r0 = next(c for c in main_cases if c["case"] == "R0" and c["k"] == 1)
    kernels = [
        dict(name="csr_spmv_capped", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:77",
             launches=launches[0],
             max_abs_err=max(c["err1"] for c in main_cases),
             ms=a0["k1_ms"], plain_ms=a0["k1_plain_ms"]),
        dict(name="coo_patch", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:457",
             launches=launches[1],
             max_abs_err=max(c["err2"] for c in main_cases),
             ms=r0["k2_ms"], plain_ms=r0["k2_plain_ms"]),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
