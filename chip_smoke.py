"""Drive the PyTorch/CUDA port (tpu_amg_torch) once on one GPU and check it.

Usage: python3 chip_smoke.py [--side 64] [--reps 50]

Phases, one printed line per result; any failed check exits non-zero:
  1. device: nvidia-smi's name and power limit, torch / CUDA / nvcc / g++;
  2. builds: the three CUDA kernel libraries (nvcc: K1 + K2, K3, the
     stream probe) and the native host library (g++), from the sources
     in this checkout, all four compilers started together;
  3. K1/K2 vs their plain PyTorch versions on the card: a random
     heavy-row matrix with a small cap, then the level-0 A, P and R of the
     SA path's hierarchy; mv and mm (k=8, and for A the bootstrap's
     k=7), float64 and float32; errors, and the device's time per call:
     CUDA events around the replay of a CUDA graph of 50 calls (median of
     5 replays);
  4. SA path: AMGSolver.setup on unstructured_poisson_3d(side) with the
     scalar 3-D SA config, then 3 PCG solves of A x = A x_true (seeded
     x_true) to rtol 1e-6; the kernels' launch counts over that run must
     be > 0; the V-cycle's time as the solve runs it (enqueued from
     Python) and the device's own time for it (graph replays);
  5. a small SA input solved on the card and, from the same hierarchy,
     on the CPU through the plain versions: the two must agree;
  6. stream probe: its entry point (python -m
     tpu_amg_torch.tools.streambench, 32 MiB per call) with the launch
     count read over that run; then every case against its plain
     version on the same inputs (exact: they are integers), GB/s of
     both, the kernel's from the entry point's run; the best
     float32 case again at 1 GiB per call, past the 50 MB L2: the read
     bandwidth of device memory;
  7. structured path: build_structured_multigrid on poisson3d(100)
     (1,000,000 dofs) in float64 (DIA levels through K3),
     its levels, then 3 PCG solves of A x = A x_true to rtol 1e-6; the
     launch counts over that run must be > 0; the V-cycle's times;
  8. K3 vs its plain version at that path's level-0 and level-1
     operators, k = 1, 7, 8, float64 and float32, with K1 + K2 on the
     same matrices as a capped CSR beside it; K1/K2 vs their plain
     versions at the path's CSR level (level 2, outside the DIA
     envelope: most rows spill to K2), k = 1, 8, float64 and float32;
  9. a small structured input on the card and on the CPU: the two must
     agree.
Every count is set to 0 just before each path (4, 6, 7) and read just
after it, before the comparison launches.  The last two lines are a
JSON object of per-kernel results and the device line.  With no CUDA
device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

RTOL = 1e-6
MAX_ITERS = 46  # twice the reference's 23 PCG iterations for this config
STRUCTURED_SIDE = 100  # poisson3d(100): 1,000,000 dofs
MAX_ITERS_STRUCTURED = 14  # twice the reference's 7 at poisson3d(100)
TOL = {"float64": 1e-12, "float32": 1e-5}  # f64: atomics reorder sums
STREAM_MIB = 32  # the harness's TOTAL (tools/streambench.py:25)
STREAM_BIG_MIB = 1024  # past the card's 50 MB L2
HBM_DATASHEET_GBPS = 3350.0  # H100 SXM data sheet


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    say(("ok    " if ok else "FAIL  ") + msg)
    if not ok:
        sys.exit(1)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


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
    from tpu_amg_torch.utils.timing import median_ms

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


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from tpu_amg_torch.ops import dia, spmv, stream

    spmv.reset_launch_counts()
    dia.reset_launch_counts()
    stream.reset_launch_counts()


def stream_cases(bench_records, reps):
    """Every case of the probe against its plain version on the inputs
    the entry point timed (seed 0, 32 MiB per call), with the kernel's
    time from the entry point's run; the best float32 case again past
    L2.  Returns (per-case records, best float32 record, its record past
    L2)."""
    import torch

    from tpu_amg_torch.ops import stream
    from tpu_amg_torch.tools import streambench
    from tpu_amg_torch.utils.timing import median_ms

    dev = torch.device("cuda")
    records = []
    for bench in bench_records:
        case = next(c for c in streambench.CASES if c.name == bench["name"])
        g = torch.Generator(device=dev).manual_seed(0)
        inputs = streambench.make_inputs(case, STREAM_MIB << 20, dev, g)
        carry = torch.full((8, 128), 1.0, device=dev)
        y = stream.stream_sum(inputs, carry)
        p = stream.plain_stream_sum(inputs, carry)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        t = bench["ms"]
        tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), reps,
                       graph=True)
        nbytes = bench["bytes"]
        rec = dict(name=case.name, dtype=str(case.dtype), err=err, ms=t,
                   plain_ms=tp, gbps=bench["gbps"],
                   plain_gbps=nbytes / tp / 1e6)
        records.append(rec)
        check(err == 0.0,
              f"stream {case.name}: {nbytes} B per call, max abs err "
              f"{err:.1e} (limit 0: integer inputs); kernel {t * 1e3:.1f} us "
              f"{rec['gbps']:.1f} GB/s, plain {tp * 1e3:.1f} us "
              f"{rec['plain_gbps']:.1f} GB/s")
        del inputs
    best = max((r for r in records if r["dtype"] == "torch.float32"),
               key=lambda r: r["gbps"])
    case = next(c for c in streambench.CASES if c.name == best["name"])
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = streambench.make_inputs(case, STREAM_BIG_MIB << 20, dev, g)
    carry = torch.zeros(8, 128, device=dev)
    nbytes = case.tiles(STREAM_BIG_MIB << 20) * case.tile_bytes
    t = median_ms(lambda: stream.stream_sum(inputs, carry), 20, graph=True)
    tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), 20,
                   graph=True)
    big = dict(name=case.name, ms=t, plain_ms=tp, gbps=nbytes / t / 1e6,
               plain_gbps=nbytes / tp / 1e6)
    return records, best, big


def dia_to_csr(dia):
    """The host CSR of a DIA matrix (its stored nonzeros)."""
    from tpu_amg_torch.sparse.csr import CSR

    n = dia.shape[0]
    offsets = np.asarray(dia.offsets, dtype=np.int64)
    rows = np.tile(np.arange(n, dtype=np.int64), len(offsets))
    cols = rows + np.repeat(offsets, n)
    vals = dia.data.double().cpu().numpy().ravel()
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    return CSR.from_coo(rows[keep], cols[keep], vals[keep], dia.shape)


def dia_kernel_cases(name, dia64, csr, reps, results, ks=(1, 7, 8)):
    """K3 against its plain version on one DIA matrix, float64 and
    float32; device times of K3, the plain version and K1 + K2 on the
    same matrix as a capped CSR (CUDA graph replays)."""
    import torch

    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.utils.timing import median_ms

    n, n_diags = dia64.shape[0], len(dia64.offsets)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        mat = dia64 if dtype == torch.float64 else dia64.astype(dtype)
        capped = spmv.CappedCSR.from_csr(csr, "cuda", dtype)
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (n,) if k == 1 else (n, k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            y = dia_ops.dia_spmv(mat, x)
            p = dia_ops.plain_dia_spmv(mat, x)
            yc = spmv.spmv(capped, x)
            torch.cuda.synchronize()
            scale = max(float(p.abs().max()), 1e-300)
            err = float((y - p).abs().max())
            rel_csr = float((yc - p).abs().max()) / scale
            t = median_ms(lambda: dia_ops.dia_spmv(mat, x), reps, graph=True)
            tp = median_ms(lambda: dia_ops.plain_dia_spmv(mat, x), reps,
                           graph=True)
            tc = median_ms(lambda: spmv.spmv(capped, x), reps, graph=True)
            isz = x.element_size()
            dia_bytes = (n_diags * n + 2 * n * k) * isz
            csr_bytes = (capped.nnz * (isz + 4) + 8 * (n + 1)
                         + 2 * n * k * isz)
            check(
                err / scale <= TOL[dname] and rel_csr <= TOL[dname],
                f"K3 {name} {dname} k={k}: n {n}, {n_diags} diagonals, "
                f"nnz {dia64.nnz}: max rel err {err / scale:.3e} (K1+K2 "
                f"{rel_csr:.3e}; limit {TOL[dname]:.0e}); K3 {t * 1e3:.2f} us "
                f"({dia_bytes / t / 1e6:.0f} GB/s of {dia_bytes / 1e6:.1f} "
                f"MB), plain {tp * 1e3:.2f} us, K1+K2 as CSR {tc * 1e3:.2f} "
                f"us ({csr_bytes / tc / 1e6:.0f} GB/s of "
                f"{csr_bytes / 1e6:.1f} MB)",
            )
            results.append(dict(case=name, dtype=dname, k=k, err=err, ms=t,
                                plain_ms=tp, csr_ms=tc, bytes=dia_bytes,
                                csr_bytes=csr_bytes))


def level_lines(mg):
    """One description per level of a multigrid: rows, format,
    diagonals, stored entries."""
    import torch

    from tpu_amg_torch.linop import DenseOperator
    from tpu_amg_torch.sparse.dia import DIA

    lines = []
    for lvl, level in enumerate(mg.levels):
        op = level.a
        if isinstance(op, DenseOperator):
            desc = f"dense, nnz {int(torch.count_nonzero(op.mat))}"
        elif isinstance(op.mat, DIA):
            desc = f"DIA (K3), {len(op.mat.offsets)} diagonals, nnz {op.mat.nnz}"
        else:
            desc = (f"CSR (K1+K2), nnz {op.mat.nnz} "
                    f"({op.mat.nnz / op.shape[0]:.1f}/row), "
                    f"tail {op.mat.n_tail}")
        lines.append(f"  level {lvl}: n={op.shape[0]} {desc}")
    lines.append(f"  coarse: n={mg.coarse_solver.shape[0]} dense Cholesky "
                 f"inverse")
    return lines


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
    from tpu_amg_torch.ops import _build, native, spmv, stream
    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg_torch.solver import AMGSolver
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.sparse.dia import DIA
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.tools import streambench
    from tpu_amg_torch.utils.problems import poisson3d, unstructured_poisson_3d
    from tpu_amg_torch.utils.timing import median_ms

    # ---- 1. device
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; "
        f"nvcc {run([_build.nvcc_path(), '--version']).splitlines()[-1]}; "
        f"g++ {run(['g++', '-dumpfullversion'])}")

    # ---- 2. builds, from this checkout's sources
    builds = {
        "libamg_kernels.so (nvcc, sm_90a)": spmv.kernel_lib,
        "libamg_dia.so (nvcc, sm_90a)": dia_ops.kernel_lib,
        "libamg_stream.so (nvcc, sm_90a)": stream.kernel_lib,
        "libamg_native.so (g++)": native.lib,
    }
    for label in builds:
        (_build.BUILD_DIR / label.split()[0]).unlink(missing_ok=True)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = {label: pool.submit(timed, fn) for label, fn in builds.items()}
        build_s = {label: f.result() for label, f in futures.items()}
    say("build: " + "; ".join(f"{k} {v:.1f} s" for k, v in build_s.items())
        + f"; {time.perf_counter() - t0:.1f} s in all, side by side")

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
    reset_counts()
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
        f"launches over the SA path: csr_spmv_capped {launches[0]} "
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

    # ---- 6. stream probe: its entry point, then each case vs plain
    reset_counts()
    bench_recs = streambench.run(["--total-mib", str(STREAM_MIB), "--reps",
                                  str(args.reps)])
    torch.cuda.synchronize()
    stream_launches = stream.stream_sum_launches
    check(stream_launches > 0,
          f"launches over the stream probe: stream_sum {stream_launches}")
    stream_recs, best, big = stream_cases(bench_recs, args.reps)
    say(f"stream read bandwidth: best float32 case {best['name']!r}: "
        f"{best['gbps']:.1f} GB/s at {STREAM_MIB} MiB per call (held in "
        f"the 50 MB L2), {big['gbps']:.1f} GB/s at {STREAM_BIG_MIB} MiB "
        f"({big['ms'] * 1e3:.1f} us per call): device memory, "
        f"{big['gbps'] / HBM_DATASHEET_GBPS:.1%} of the "
        f"{HBM_DATASHEET_GBPS:.0f} GB/s data sheet; plain version "
        f"{big['plain_gbps']:.1f} GB/s ({big['plain_ms'] * 1e3:.1f} us)")

    # ---- 7. structured path: DIA levels through K3
    side = STRUCTURED_SIDE
    t0 = time.perf_counter()
    ps = poisson3d(side)
    say(f"problem: poisson3d({side}): n={ps.nrows} nnz={ps.nnz} built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    smg = build_structured_multigrid(ps, (side,) * 3, device="cuda",
                                     coarsest_dim=1000, dtype=torch.float64)
    s_op = SparseOperator.from_csr(ps, "cuda", torch.float64)
    torch.cuda.synchronize()
    say(f"structured setup: {time.perf_counter() - t0:.1f} s; "
        f"{len(smg.levels) + 1} levels")
    for line in level_lines(smg):
        say(line)
    check(isinstance(s_op.mat, DIA), f"structured A is "
          f"{type(s_op.mat).__name__} (expected DIA)")
    s_solve = []
    for i in range(3):
        x_true = np.random.default_rng(100 + i).standard_normal(ps.nrows)
        b = dia_ops.plain_dia_spmv(s_op.mat, torch.from_numpy(x_true).cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = cg(s_op, b, smg, rtol=RTOL, maxiter=200)
        torch.cuda.synchronize()
        s_solve.append(time.perf_counter() - t0)
        true_rel = float(
            torch.linalg.vector_norm(b - dia_ops.plain_dia_spmv(s_op.mat, x))
            / torch.linalg.vector_norm(b))
        check(
            info.converged and info.iters <= MAX_ITERS_STRUCTURED
            and np.isfinite(true_rel) and true_rel <= 1.01 * RTOL
            and tuple(x.shape) == (ps.nrows,),
            f"structured solve {i}: {s_solve[-1]:.3f} s, {info.iters} "
            f"iterations (limit {MAX_ITERS_STRUCTURED}), true relative "
            f"residual {true_rel:.3e} (limit {1.01 * RTOL:.3e})",
        )
    torch.cuda.synchronize()
    s_launches = dict(dia_spmv=dia_ops.dia_spmv_launches,
                      csr_spmv_capped=spmv.csr_spmv_launches,
                      coo_patch=spmv.coo_patch_launches)
    csr_levels = [lvl.a.mat for lvl in smg.levels
                  if isinstance(lvl.a, SparseOperator)
                  and not isinstance(lvl.a.mat, DIA)]
    check(
        s_launches["dia_spmv"] > 0
        and (not csr_levels or s_launches["csr_spmv_capped"] > 0)
        and (not any(m.n_tail for m in csr_levels)
             or s_launches["coo_patch"] > 0),
        "launches over the structured path: " + ", ".join(
            f"{k} {v}" for k, v in s_launches.items()),
    )
    rs = torch.from_numpy(np.random.default_rng(7).standard_normal(ps.nrows)).cuda()
    t_svc = median_ms(lambda: smg.mv(rs), 20)
    t_svc_dev = median_ms(lambda: smg.mv(rs), 20, graph=True)
    say(f"structured V-cycle: {t_svc:.3f} ms as the solve runs it "
        f"(enqueued from Python), {t_svc_dev:.3f} ms on the device (CUDA "
        f"graph replay); solves " + ", ".join(f"{s:.3f}" for s in s_solve)
        + " s")

    # ---- 8. K3 vs plain at the structured path's level-0 and level-1 shapes
    dia_results = []
    for lvl, name in ((0, "A0"), (1, "A1")):
        mat = smg.levels[lvl].a.mat
        check(isinstance(mat, DIA), f"structured level {lvl} is DIA")
        dia_kernel_cases(name, mat, ps if lvl == 0 else dia_to_csr(mat),
                         args.reps, dia_results)
    check(len(csr_levels) > 0, f"the structured path has "
          f"{len(csr_levels)} CSR levels (expected level 2)")
    for lvl, level in enumerate(smg.levels):
        mat = getattr(level.a, "mat", None)
        if isinstance(mat, spmv.CappedCSR):
            kernel_cases(
                f"S{lvl}",
                {torch.float64: mat,
                 torch.float32: spmv.CappedCSR.from_csr(
                     mat.to_csr(), "cuda", torch.float32)},
                args.reps, results,
            )

    # ---- 9. small structured input: card vs the plain versions on the CPU
    n24 = 24
    small_s = poisson3d(n24)
    mgs = {dev: build_structured_multigrid(
        small_s, (n24,) * 3, device=dev, coarsest_dim=64, dtype=torch.float64)
        for dev in ("cuda", "cpu")}
    b_np = np.random.default_rng(3).standard_normal(small_s.nrows)
    sols = {}
    for dev, mg in mgs.items():
        op = SparseOperator.from_csr(small_s, dev, torch.float64)
        b_dev = torch.from_numpy(b_np).to(dev)
        x, info = cg(op, b_dev, mg, rtol=RTOL)
        sols[dev] = (x.cpu(), info, mg.mv(b_dev).cpu())
    (xg, ig, zg), (xc, ic, zc) = sols["cuda"], sols["cpu"]
    dz = float((zg - zc).abs().max() / zc.abs().max())
    dx = float((xg - xc).abs().max() / xc.abs().max())
    check(
        ig.converged and ig.iters == ic.iters and dz <= 1e-10 and dx <= 1e-6,
        f"small structured input poisson3d({n24}), {len(mgs['cuda'].levels) + 1} "
        f"levels: card {ig.iters} / CPU {ic.iters} iterations; V-cycle rel "
        f"diff {dz:.2e} (limit 1e-10); solution rel diff {dx:.2e} "
        f"(limit 1e-6)",
    )

    # ---- results
    # both paths run float64: their errors go in the record, the SA
    # path's level-0 times beside them
    main_cases = [c for c in results
                  if (c["case"] in ("A0", "P0", "R0")
                      or c["case"].startswith("S"))
                  and c["dtype"] == "float64"]
    a0 = next(c for c in main_cases if c["case"] == "A0" and c["k"] == 1)
    r0 = next(c for c in main_cases if c["case"] == "R0" and c["k"] == 1)
    d0 = next(c for c in dia_results if c["case"] == "A0"
              and c["dtype"] == "float64" and c["k"] == 1)
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
        # the structured path runs float64 at A0 and A1
        dict(name="dia_spmv", route="cuda",
             source="tpu_amg_torch/csrc/dia.cu",
             replaces="tpu_amg/ops/dia_pallas.py:34",
             launches=s_launches["dia_spmv"],
             max_abs_err=max(c["err"] for c in dia_results
                             if c["dtype"] == "float64"),
             ms=d0["ms"], plain_ms=d0["plain_ms"]),
        dict(name="stream_sum", route="cuda",
             source="tpu_amg_torch/csrc/stream.cu",
             replaces="tools/streambench.py:38, tools/streambench.py:96",
             launches=stream_launches,
             max_abs_err=max(r["err"] for r in stream_recs),
             ms=best["ms"], plain_ms=best["plain_ms"]),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
