"""Drive the PyTorch/CUDA port (tpu_amg_torch) once on one GPU and check it.

Usage: python3 chip_smoke.py [--side 64] [--reps 50]

Phases, one printed line per result; any failed check exits non-zero:
  1. device: nvidia-smi's name and power limit, torch / CUDA / nvcc / g++;
  2. builds: the six CUDA kernel libraries (nvcc: K1 + K2, K3, the
     stream probe, K1's stage ablations, the copy probe, the primitive
     probe) and the native host library (g++), from the sources in this
     checkout, all seven compilers started together;
  3. K1/K2 vs their plain PyTorch versions on the card: a random
     heavy-row matrix with a small cap, then every A, P and R of the SA
     path's hierarchy that K1 ran on (and all of levels 0 and 1); mv and
     mm (k=8, every k the SA path ran on that matrix, and for A0 the
     bootstrap's k=7), float64 and float32; errors, two K2 calls bitwise
     equal, the tail's rows and longest row, and the device's
     time per call: CUDA events around the replay of a CUDA graph of 50
     calls (median of 5 replays); beside them, at every k, the library's
     own SpMV or SpMM (a torch sparse CSR tensor of the capped part, and
     of the tail, `@ x`) timed the same way, and the bound: the bytes
     each call must move over the 3,350 GB/s data sheet (for K2 also
     its first design's, a row id per entry); at k=1 also
     K1's first design (`rowgroup`); then
     K1's and K2's launches on the SA path by matrix, times (time -
     bound);
  4. SA path: AMGSolver.setup on unstructured_poisson_3d(side) with the
     scalar 3-D SA config, then 3 PCG solves of A x = A x_true (seeded
     x_true) to rtol 1e-6; the kernels' launch counts over that run must
     be > 0, and K1's and K2's are printed by (rows, cols, k); the
     V-cycle's time
     as the solve runs it (enqueued from Python) and the device's own
     time for it (graph replays);
  5. a small SA input solved on the card and, from the same hierarchy,
     on the CPU through the plain versions: the two must agree;
  6. stream probe: its entry point (python -m
     tpu_amg_torch.tools.streambench, 32 MiB per call) with the launch
     count read over that run; then every case against its plain
     version (torch.sum over the view) on the same inputs (exact: they
     are integers), two calls bitwise equal, times and GB/s of both, the
     kernel's from the entry point's run; the single-input float32 cases
     again at 1 GiB per call, past the 50 MB L2: the read bandwidth of
     device memory, beside torch.sum's, and the copy probe's best
     configuration on as many bytes;
  7. structured path: build_structured_multigrid on poisson3d(100)
     (1,000,000 dofs) in float64 (DIA levels through K3),
     its levels, then 3 PCG solves of A x = A x_true to rtol 1e-6; the
     launch counts over that run must be > 0, K2's printed by (rows,
     cols, k); the V-cycle's times;
  8. K3 vs its plain version at that path's level-0 and level-1
     operators, k = 1, 7, 8, float64 and float32, with K1 + K2 on the
     same matrices as a capped CSR beside it; K1/K2 vs their plain
     versions at the path's CSR level (level 2, outside the DIA
     envelope: every row spills to K2), k = 1, 8 and every k the path
     ran, float64 and float32, as in phase 3; then K2's launches on the
     structured path, times (time - bound);
  9. a small structured input on the card and on the CPU: the two must
     agree;
 10. stage ablation of K1: its entry point (python -m
     tpu_amg_torch.tools.wellablate) on unstructured_fem_system(1024)
     (1,048,576 rows, 7,339,948 entries) in float32, then the same modes
     in float64 on the SA path's A0, R0 and A1 from phase 4; every mode
     against its plain version, `full` bitwise equal to K1 on every
     matrix; `full` (= K1, the row-block design), `rowgroup` (K1's first
     design), the library's SpMV and the bound side by side;
 11. copy probes: the entry points python -m tpu_amg_torch.tools.dmabench
     (D1's sweep, both engines, 32 MiB per call) and dmabench2 (D2-D4);
     every case against its plain version, exactly (integer inputs); the
     sweep again at 1 GiB per call, past the 50 MB L2, and its best case
     against its plain version there;
 12. primitives: the entry point python -m
     tpu_amg_torch.tools.microbench_primitives at 4096 tiles (ns per op
     against the issue-rate bound at the SM clock nvidia-smi reports);
     every op against its plain version on the inputs it timed, at
     inner 16 and 272; the SASS of the HI kernels (cuobjdump): every
     step issued, nothing spilled to local memory.
Every count is set to 0 just before each path (4, 6, 7, 10, 11, 12) and
read just after it, before the comparison launches.  The last two lines
are a JSON object of per-kernel results (with each kernel's bound and
the library call's time) and the device line.  With no CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

RTOL = 1e-6
MAX_ITERS = 46  # twice the reference's 23 PCG iterations for this config
STRUCTURED_SIDE = 100  # poisson3d(100): 1,000,000 dofs
MAX_ITERS_STRUCTURED = 14  # twice the reference's 7 at poisson3d(100)
# the kernels sum in another order than the plain versions
TOL = {"float64": 1e-12, "float32": 1e-5}
STREAM_MIB = 32  # the harness's TOTAL (tools/streambench.py:25)
STREAM_BIG_MIB = 1024  # past the card's 50 MB L2
FEM_SIDE = 1024  # unstructured_fem_system(1024): the harnesses' 1M matrix
PRIMITIVE_OP = "gather_fma"  # the WELL stage-B core: the kernels-line case
COPY_BEST = "depth= 2 unit=64KB"  # a best case of the copy sweep at 1 GiB


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    say(("ok    " if ok else "FAIL  ") + msg)
    if not ok:
        sys.exit(1)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


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


def torch_csr(indptr, indices, data, shape):
    """A torch sparse CSR tensor on the card (int32 indices): ``@ x`` is
    the library's SpMV (cuSPARSE), the yardstick beside a kernel; the
    port never calls it."""
    import torch

    return torch.sparse_csr_tensor(indptr.to(torch.int32),
                                   indices.to(torch.int32), data, shape)


def tail_csr(mat):
    """K2's tail of a CappedCSR as its own torch CSR tensor."""
    import torch

    counts = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    counts[mat.tail_row_ids.long()] = (mat.tail_ptr[1:]
                                       - mat.tail_ptr[:-1]).long()
    indptr = torch.zeros(mat.shape[0] + 1, dtype=torch.int64,
                         device=mat.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return torch_csr(indptr, mat.tail_cols, mat.tail_vals, mat.shape)


def k2_bytes(mat, k: int):
    """K2 at k columns, each input once: the tail's columns and values,
    its row table (row ids and starts), the X rows it reads, and the Y
    rows it reads and writes.  Also the first design's (a row id per
    entry, no table), for the record."""
    import torch

    isz = mat.data.element_size()
    cols = int(torch.unique(mat.tail_cols).numel())
    rows = mat.n_tail_rows
    xy = (cols + 2 * rows) * k * isz
    return (mat.n_tail * (4 + isz) + 4 * (2 * rows + 1) + xy,
            mat.n_tail * (8 + isz) + xy)


def tail_shape(mat) -> str:
    """The tail's rows, their mean and longest length, as printed."""
    lens = mat.tail_ptr[1:] - mat.tail_ptr[:-1]
    return (f"{mat.n_tail_rows} tail rows, mean "
            f"{mat.n_tail / max(mat.n_tail_rows, 1):.1f}, longest "
            f"{int(lens.max()) if mat.n_tail_rows else 0}")


def k2_lanes_sweep(mat, x, k, reps) -> dict:
    """K2's time at every team width it takes at k columns (lanes a tail
    row), through the uncounted launcher, on a zeroed Y."""
    import torch

    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.utils.timing import median_ms

    yz = torch.zeros((mat.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    first = min(32, 1 << (k - 1).bit_length())  # the group width
    return {lanes: median_ms(
        lambda lanes=lanes: spmv.launch_coo_patch(mat, x, yz, k, lanes),
        reps, graph=True) for lanes in (8, 16, 32) if lanes >= first}


def kernel_cases(name, mat_by_dtype, reps, results, ks=(1, 8)):
    """Compare K1, K2 and K1+K2 with the plain versions on one matrix;
    time each on the device (CUDA graph replays) beside the library's
    SpMV / SpMM on the capped part and on the tail, and the bounds; at
    k=1 also K1's first design (the ablation's `rowgroup`)."""
    import torch

    from tpu_amg_torch.ops import spmv, spmv_stages
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    for dtype, mat in mat_by_dtype.items():
        dname = str(dtype).replace("torch.", "")
        lib1 = torch_csr(mat.indptr, mat.indices, mat.data, mat.shape)
        lib2 = tail_csr(mat) if mat.n_tail else None
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
            x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            y1 = spmv.csr_spmv_capped(mat, x)
            p1 = spmv.plain_csr_spmv_capped(mat, x)
            y2 = torch.zeros_like(y1)
            p2 = torch.zeros_like(y1)
            again = torch.zeros_like(y1)
            spmv.coo_patch(mat, x, y2)
            spmv.coo_patch(mat, x, again)
            spmv.plain_coo_patch(mat, x, p2)
            y = y1 + y2
            p = p1 + p2
            torch.cuda.synchronize()
            same = torch.equal(y2, again)
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
            lib = dict(k1_lib_ms=median_ms(lambda: lib1 @ x, reps, graph=True),
                       k1_bound_ms=hbm_bound_ms(spmv.k1_bytes(mat, k)),
                       k2_lib_ms=None, k2_bound_ms=None,
                       k2_old_bound_ms=None, rowgroup_ms=None,
                       k2_by_lanes=None, k2_lanes=None)
            if k == 1:
                lib["rowgroup_ms"] = median_ms(
                    lambda: spmv_stages.csr_spmv_stages(mat, x, "rowgroup"),
                    reps, graph=True)
            if lib2 is not None:
                lib["k2_lib_ms"] = median_ms(lambda: lib2 @ x, reps,
                                             graph=True)
                new, old = k2_bytes(mat, k)
                lib["k2_bound_ms"] = hbm_bound_ms(new)
                lib["k2_old_bound_ms"] = hbm_bound_ms(old)
                if dtype == torch.float64 and k in (1, 8):
                    lib["k2_by_lanes"] = k2_lanes_sweep(mat, x, k, reps)
                    lib["k2_lanes"] = spmv.k2_lanes(
                        mat.n_tail_rows, k, spmv.sm_count(x.device.index))
            check(
                rel <= TOL[dname] and same,
                f"kernels {name} {dname} k={k}: shape {mat.shape} "
                f"nnz {mat.nnz} tail {mat.n_tail} row blocks "
                f"{mat.n_blocks}: max rel err {rel:.3e} (limit "
                f"{TOL[dname]:.0e}); K1 {t1:.4f} ms plain {t1p:.4f} ms "
                f"library {lib['k1_lib_ms']:.4f} ms bound "
                f"{lib['k1_bound_ms']:.4f} ms"
                + ("" if k != 1 else
                   f" (K1's first design {lib['rowgroup_ms']:.4f} ms)")
                + f"; K2 {t2:.4f} ms plain {t2p:.4f} ms"
                + ("" if lib2 is None else
                   f" library {lib['k2_lib_ms']:.4f} ms bound "
                   f"{lib['k2_bound_ms']:.4f} ms (first design's "
                   f"{lib['k2_old_bound_ms']:.4f}; {tail_shape(mat)}"
                   + ("" if lib["k2_by_lanes"] is None else
                      f"; by lanes a row ({lib['k2_lanes']} in use): "
                      + ", ".join(
                          f"{n} {t * 1e3:.2f} us"
                          for n, t in lib["k2_by_lanes"].items()))
                   + f"); two K2 calls bitwise equal: {same}"),
            )
            results.append(dict(case=name, dtype=dname, k=k,
                                shape=tuple(mat.shape), err1=err1,
                                err2=err2, k1_ms=t1, k1_plain_ms=t1p,
                                k2_ms=t2, k2_plain_ms=t2p,
                                n_tail=mat.n_tail, **lib))


def say_excess(kernel, key, path, by_shape, results, cases):
    """Print a kernel's launches x (time - bound) on a path, for each
    (rows, cols, k) it ran there, from the float64 times of ``cases``."""
    excess, total = [], 0.0
    for shape, count in sorted(by_shape.items()):
        case = next((c for c in results if c["dtype"] == "float64"
                     and (*c["shape"], c["k"]) == shape
                     and c["case"] in cases), None)
        if case is None:
            excess.append(f"{shape}: {count} launches, not timed")
            continue
        ms = count * (case[f"{key}_ms"] - case[f"{key}_bound_ms"])
        total += ms
        excess.append(f"{case['case']} k={shape[2]} {shape}: {count} x "
                      f"({case[f'{key}_ms'] * 1e3:.2f} - "
                      f"{case[f'{key}_bound_ms'] * 1e3:.2f} us) = {ms:.3f} ms")
    say(f"{kernel} on {path}, launches x (time - bound), float64: "
        f"{total:.3f} ms in all; " + "; ".join(excess))


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from tpu_amg_torch.ops import dia, dma, primitives, spmv, spmv_stages, stream

    for module in (spmv, dia, stream, spmv_stages, dma, primitives):
        module.reset_launch_counts()


def stream_cases(bench_records, reps):
    """Every case of the probe against its plain version on the inputs
    the entry point timed (seed 0, 32 MiB per call), with the kernel's
    time from the entry point's run, and two calls bitwise equal; the
    single-input float32 cases again past L2, checked the same way and
    timed beside torch.sum and their bound, and the copy probe's best
    configuration on as many bytes.  Returns (the records at 32 MiB, the
    best float32 one, the records past L2, the best of those)."""
    import torch

    from tpu_amg_torch.ops import stream
    from tpu_amg_torch.tools import dmabench, streambench
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    dev = torch.device("cuda")
    records = []
    for bench in bench_records:
        case = next(c for c in streambench.CASES if c.name == bench["name"])
        g = torch.Generator(device=dev).manual_seed(0)
        inputs = streambench.make_inputs(case, STREAM_MIB << 20, dev, g)
        carry = torch.full((8, 128), 1.0, device=dev)
        y = stream.stream_sum(inputs, carry)
        again = stream.stream_sum(inputs, carry)
        p = stream.plain_stream_sum(inputs, carry)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        same = torch.equal(y, again)
        t = bench["ms"]
        tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), reps,
                       graph=True)
        nbytes = bench["bytes"]
        # the library call is torch.sum over the same view: the plain
        # version; the bound counts the reads and the (tiles, 8, 128) sums
        rec = dict(name=case.name, dtype=str(case.dtype), err=err, ms=t,
                   plain_ms=tp, gbps=bench["gbps"],
                   plain_gbps=nbytes / tp / 1e6,
                   bound_ms=hbm_bound_ms(nbytes + bench["tiles"] * 4096))
        records.append(rec)
        check(err == 0.0 and same,
              f"stream {case.name}: {nbytes} B per call, max abs err "
              f"{err:.1e} (limit 0: integer inputs), two calls bitwise "
              f"equal: {same}; kernel {t * 1e3:.2f} us "
              f"{rec['gbps']:.1f} GB/s, plain (torch.sum, the library "
              f"call) {tp * 1e3:.2f} us {rec['plain_gbps']:.1f} GB/s "
              f"({'at or under' if t <= tp else 'over'} it); bytes over "
              f"the HBM rate {rec['bound_ms'] * 1e3:.1f} us (held in L2: "
              f"not a floor)")
        del inputs
    best = max((r for r in records if r["dtype"] == "torch.float32"),
               key=lambda r: r["gbps"])
    # every single-input float32 case past L2, beside torch.sum
    bigs = []
    for case in streambench.CASES:
        if case.dtype != torch.float32 or case.n_in != 1:
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        inputs = streambench.make_inputs(case, STREAM_BIG_MIB << 20, dev, g)
        carry = torch.zeros(8, 128, device=dev)
        tiles = case.tiles(STREAM_BIG_MIB << 20)
        nbytes = tiles * case.tile_bytes
        y = stream.stream_sum(inputs, carry)
        again = stream.stream_sum(inputs, carry)
        p = stream.plain_stream_sum(inputs, carry)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        same = torch.equal(y, again)
        del y, again, p
        t = median_ms(lambda: stream.stream_sum(inputs, carry), 20,
                      graph=True)
        tp = median_ms(lambda: stream.plain_stream_sum(inputs, carry), 20,
                       graph=True)
        del inputs
        # past L2 the bytes over the HBM rate are a floor
        bigs.append(dict(name=case.name, err=err, ms=t, plain_ms=tp,
                         gbps=nbytes / t / 1e6, plain_gbps=nbytes / tp / 1e6,
                         bound_ms=hbm_bound_ms(nbytes + tiles * 4096)))
        check(err == 0.0 and same,
              f"stream {case.name} at {STREAM_BIG_MIB} MiB: max abs err "
              f"{err:.1e} (limit 0), two calls bitwise equal: {same}; "
              f"kernel {t * 1e3:.1f} us {bigs[-1]['gbps']:.1f} GB/s, "
              f"torch.sum {tp * 1e3:.1f} us {bigs[-1]['plain_gbps']:.1f} "
              f"GB/s, bound {bigs[-1]['bound_ms'] * 1e3:.1f} us")
    big = max(bigs, key=lambda r: r["gbps"])
    # the copy probe's best configuration, both engines, on as many bytes
    copy = dmabench.run(["--total-mib", str(STREAM_BIG_MIB), "--reps", "10",
                         COPY_BEST])
    big["copy_gbps"] = max(r["gbps"] for r in copy)
    return records, best, bigs, big


def ablation_phase(sa_mats, reps):
    """Phase 10: K1's stage ablation through its entry point on the FEM
    1M matrix in float32, then on the SA path's matrices ``sa_mats``
    (label -> float64 CappedCSR); every mode against its plain version,
    both timed; ``full`` bitwise against K1, and timed beside K1 and the
    library's SpMV.  Returns the kernels-line entry."""
    import torch

    from tpu_amg_torch.ops import spmv, spmv_stages
    from tpu_amg_torch.tools import wellablate
    from tpu_amg_torch.utils.timing import median_ms

    torch.cuda.synchronize()
    reset_counts()
    recs, fem, x32 = wellablate.run(["--side", str(FEM_SIDE), "--dtype", "f32",
                                     "--reps", str(reps)])
    cases = [("fem1024", fem, x32)]
    for label, mat in sa_mats.items():
        x = wellablate.make_x(mat.shape[1], "cuda", torch.float64)
        recs += wellablate.time_modes(mat, x, spmv_stages.MODES, reps, label)
        cases.append((label, mat, x))
    torch.cuda.synchronize()
    launches = spmv_stages.stages_launches
    check(launches > 0, f"launches over the ablation: csr_spmv_stages "
          f"{launches}")
    errs = []
    full = {}
    for label, mat, x in cases:
        dname = str(x.dtype).replace("torch.", "")
        # errors relative to the sums of |terms|: the FEM rows sum to
        # 1e-8, so nogather's x[r]·Σ v_j is all cancellation
        mat_abs = dataclasses.replace(mat, data=mat.data.abs())
        for mode in spmv_stages.MODES:
            y = spmv_stages.csr_spmv_stages(mat, x, mode)
            p = spmv_stages.plain_csr_spmv_stages(mat, x, mode)
            scale = float(spmv_stages.plain_csr_spmv_stages(
                mat_abs, x.abs(), mode).max())
            torch.cuda.synchronize()
            err = float((y - p).abs().max())
            errs.append(err)
            rec = next(r for r in recs if r["matrix"] == label
                       and r["mode"] == mode)
            rec["plain_ms"] = median_ms(
                lambda: spmv_stages.plain_csr_spmv_stages(mat, x, mode), reps,
                graph=True)
            check(err / scale <= TOL[dname],
                  f"ablation {label} {dname} {mode}: max abs err {err:.3e}, "
                  f"{err / scale:.3e} of the largest sum of |terms| (limit "
                  f"{TOL[dname]:.0e}); kernel {rec['ms'] * 1e3:.2f} us, plain "
                  f"{rec['plain_ms'] * 1e3:.2f} us, bound "
                  f"{rec['bound_ms'] * 1e3:.2f} us")
        y = spmv_stages.csr_spmv_stages(mat, x, "full")
        k1 = spmv.csr_spmv_capped(mat, x)
        check(torch.equal(y, k1), f"ablation {label} {dname}: full is "
              f"bitwise equal to csr_spmv_capped")
        rec = next(r for r in recs if r["matrix"] == label
                   and r["mode"] == "full")
        old = next(r for r in recs if r["matrix"] == label
                   and r["mode"] == "rowgroup")
        lib = torch_csr(mat.indptr, mat.indices, mat.data, mat.shape)
        rec["lib_ms"] = median_ms(lambda: lib @ x, reps, graph=True)
        rec["k1_ms"] = median_ms(lambda: spmv.csr_spmv_capped(mat, x), reps,
                                 graph=True)
        say(f"ablation {label} {dname}: full (K1, row blocks) "
            f"{rec['ms'] * 1e3:.2f} us (K1 itself {rec['k1_ms'] * 1e3:.2f} "
            f"us), rowgroup (K1's first design) {old['ms'] * 1e3:.2f} us, "
            f"library CSR @ x {rec['lib_ms'] * 1e3:.2f} us, bound "
            f"{rec['bound_ms'] * 1e3:.2f} us, plain "
            f"{rec['plain_ms'] * 1e3:.2f} us; full is "
            f"{'faster' if rec['ms'] < old['ms'] else 'not faster'} than "
            f"rowgroup, {'at or under' if rec['ms'] <= rec['lib_ms'] else 'over'}"
            f" the library")
        full[label] = rec
    say("ablation attribution (us; MB the mode must move): " + "; ".join(
        f"{r['matrix']} {r['mode']} {r['ms'] * 1e3:.2f} "
        f"({r['bytes'] / 1e6:.1f})" for r in recs))
    rec = full["fem1024"]
    return dict(name="csr_spmv_stages", route="cuda",
                source="tpu_amg_torch/csrc/spmv_stages.cu",
                replaces="tools/well2proto.py:258, tools/well2proto.py:324, "
                         "tools/well2proto.py:409, tools/wellablate.py:44, "
                         "tools/wellablate2.py:34",
                launches=launches, max_abs_err=max(errs), ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by="bytes", library_ms=rec["lib_ms"])


def dma_phase(reps):
    """Phase 11: the copy probes through their entry points; every case
    against its plain version; the sweep again at 1 GiB.  Returns the
    kernels-line entry."""
    import torch

    from tpu_amg_torch.ops import dma
    from tpu_amg_torch.tools import dmabench, dmabench2
    from tpu_amg_torch.utils.timing import HBM_DATASHEET_GBPS, median_ms

    torch.cuda.synchronize()
    reset_counts()
    recs = dmabench.run(["--reps", str(reps)])
    recs2, _ = dmabench2.run(["--reps", str(reps)])
    big = dmabench.run(["--total-mib", str(STREAM_BIG_MIB), "--reps", "10"])
    torch.cuda.synchronize()
    launches = dma.dma_probe_launches
    check(launches > 0, f"launches over the copy probes: dma_probe {launches}")
    best_big = max(big, key=lambda r: r["gbps"])
    errs = []
    dev = torch.device("cuda")
    for rec in recs + recs2 + [best_big]:
        case = rec["case"]
        g = torch.Generator(device=dev).manual_seed(0)
        srcs = dmabench.make_inputs(case, rec["total_bytes"], dev, g)
        carry = torch.full((8, 128), 1.0, device=dev)
        args = (srcs, carry, rec["chunk_rows"], case.touch_every)
        y = dma.dma_probe(*args, case.engine, case.depth, rec["unit"])
        p = dma.plain_dma_probe(*args)
        torch.cuda.synchronize()
        err = float((y - p).abs().max())
        errs.append(err)
        rec["plain_ms"] = median_ms(lambda: dma.plain_dma_probe(*args), reps,
                                    graph=True)
        check(err == 0.0,
              f"dma {case.name}, {len(srcs)} x {srcs[0].numel() >> 18} MiB: "
              f"max abs err {err:.1e} (limit 0: integer inputs); kernel "
              f"{rec['ms'] * 1e3:.1f} us {rec['gbps']:.1f} GB/s, plain (the "
              f"touched rows only) {rec['plain_ms'] * 1e3:.1f} us, bound "
              f"{rec['bound_ms'] * 1e3:.1f} us")
        del srcs
    for engine in dma.ENGINES:
        mine = [r for r in recs if r["case"].engine == engine]
        mine_big = [r for r in big if r["case"].engine == engine]
        b32 = max(mine, key=lambda r: r["gbps"])
        b1g = max(mine_big, key=lambda r: r["gbps"])
        say(f"copy engine {engine}: best {b32['gbps']:.1f} GB/s at "
            f"{STREAM_MIB} MiB ({b32['name']}, in L2), {b1g['gbps']:.1f} GB/s "
            f"at {STREAM_BIG_MIB} MiB ({b1g['name']}, device memory: "
            f"{b1g['gbps'] / HBM_DATASHEET_GBPS:.1%} of the data sheet)")
    return dict(name="dma_probe", route="cuda",
                source="tpu_amg_torch/csrc/dma.cu",
                replaces="tools/dmabench.py:39, tools/dmabench2.py:61, "
                         "tools/dmabench2.py:88, tools/dmabench2.py:130",
                launches=launches, max_abs_err=max(errs), ms=best_big["ms"],
                plain_ms=best_big["plain_ms"], bound_ms=best_big["bound_ms"],
                bound_by="bytes", library_ms=None)


def primitives_phase(reps):
    """Phase 12: the entry point at 4096 tiles; every op against its
    plain version on the inputs the entry point timed, at inner LO and
    HI; the SASS counts of the LO and HI kernels.  Returns the
    kernels-line entry."""
    import torch

    from tpu_amg_torch.ops import primitives
    from tpu_amg_torch.tools import microbench_primitives
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    reset_counts()
    recs, _ = microbench_primitives.run(["--reps", str(reps)])
    torch.cuda.synchronize()
    launches = primitives.primitive_probe_launches
    check(launches > 0, f"launches over the primitive probe: primitive_probe "
          f"{launches}")
    errs = []
    for rec in recs:
        op, tiles = rec["op"], rec["tiles"]
        # the entry point's inputs: make_inputs is seeded
        x, idx = primitives.make_inputs(op, tiles, dev)
        for inner in primitives.INNERS:
            y = primitives.primitive_probe(x, idx, op, inner)
            p = primitives.plain_primitive_probe(x, idx, op, inner)
            torch.cuda.synchronize()
            err = float((y.float() - p.float()).abs().max())
            scale = float(p.float().abs().max())
            # a fused multiply-add rounds once where the plain version
            # rounds twice; every other op is exact
            limit = 1e-6 * scale if op in ("fma", "gather_fma") else 0.0
            errs.append(err)
            check(err <= limit, f"primitive {op} at {tiles} tiles, inner "
                  f"{inner}: max abs err {err:.2e} (limit {limit:.1e})")
        if op == PRIMITIVE_OP:
            main_rec = rec
            main_rec["plain_ms"] = median_ms(
                lambda: primitives.plain_primitive_probe(
                    x, idx, op, primitives.HI), 2, graph=True)
            bytes_ms = hbm_bound_ms(x.numel() * x.element_size() * 2
                                    + idx.numel() * idx.element_size())
        del x, idx, y, p
    unfolded = primitives.sass_unfolded(primitives.sass_instruction_counts())
    check(all(ok for ok, _ in unfolded.values()),
          "SASS of the HI kernels (every step issued, no spills): "
          + "; ".join(desc for _, desc in unfolded.values()))
    rec = main_rec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops_ms = rec["tiles"] * primitives.op_bound_ns(
        PRIMITIVE_OP, sms, rec["clock_mhz"], primitives.HI) / 1e6
    say(f"primitive {PRIMITIVE_OP} at {rec['tiles']} tiles, inner "
        f"{primitives.HI}: kernel {rec['hi_ms'] * 1e3:.1f} us, plain "
        f"{rec['plain_ms'] * 1e3:.1f} us, bound "
        f"{max(ops_ms, bytes_ms) * 1e3:.1f} us (operations "
        f"{ops_ms * 1e3:.1f}, bytes {bytes_ms * 1e3:.1f}; SM clock "
        f"{rec['clock_mhz']:.0f} MHz)")
    return dict(name="primitive_probe", route="cuda",
                source="tpu_amg_torch/csrc/primitives.cu",
                replaces="tools/microbench_primitives.py:52",
                launches=launches, max_abs_err=max(errs), ms=rec["hi_ms"],
                plain_ms=rec["plain_ms"], bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None)


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
    from tpu_amg_torch.utils.timing import hbm_bound_ms, median_ms

    n, n_diags = dia64.shape[0], len(dia64.offsets)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        mat = dia64 if dtype == torch.float64 else dia64.astype(dtype)
        capped = spmv.CappedCSR.from_csr(csr, "cuda", dtype)
        lib = torch_csr(*(torch.from_numpy(a).cuda() for a in
                          (csr.indptr, csr.indices)),
                        torch.from_numpy(csr.data).to("cuda", dtype),
                        csr.shape)
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
            # the library's SpMV on the same matrix from CSR storage
            tl = (median_ms(lambda: lib @ x, reps, graph=True) if k == 1
                  else None)
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
                f"{csr_bytes / 1e6:.1f} MB)"
                + ("" if tl is None else
                   f"; library CSR @ x {tl * 1e3:.2f} us; bound "
                   f"{hbm_bound_ms(dia_bytes) * 1e3:.2f} us"),
            )
            results.append(dict(case=name, dtype=dname, k=k, err=err, ms=t,
                                plain_ms=tp, csr_ms=tc, bytes=dia_bytes,
                                csr_bytes=csr_bytes, lib_ms=tl,
                                bound_ms=hbm_bound_ms(dia_bytes)))


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
    from tpu_amg_torch.ops import (_build, dma, native, primitives, spmv,
                                   spmv_stages, stream)
    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg_torch.solver import AMGSolver, scalar_3d_config
    from tpu_amg_torch.solvers import cg
    from tpu_amg_torch.sparse.dia import DIA
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.tools import streambench
    from tpu_amg_torch.utils.problems import poisson3d, unstructured_poisson_3d
    from tpu_amg_torch.utils.timing import HBM_DATASHEET_GBPS, median_ms

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
        "libamg_stages.so (nvcc, sm_90a)": spmv_stages.kernel_lib,
        "libamg_dma.so (nvcc, sm_90a)": dma.kernel_lib,
        "libamg_primitives.so (nvcc, sm_90a)": primitives.kernel_lib,
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
    cfg = scalar_3d_config("cuda")
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
    k1_by_shape = dict(spmv.csr_spmv_launches_by_shape)
    k2_by_shape = dict(spmv.coo_patch_launches_by_shape)
    solve_counts = (launches[0] - setup_counts[0],
                    launches[1] - setup_counts[1])
    check(
        min(solve_counts) > 0 and min(launches) > 0
        and sum(k1_by_shape.values()) == launches[0]
        and sum(k2_by_shape.values()) == launches[1],
        f"launches over the SA path: csr_spmv_capped {launches[0]} "
        f"(solves {solve_counts[0]}), coo_patch {launches[1]} "
        f"(solves {solve_counts[1]}); csr_spmv_capped by (rows, cols, k): "
        + ", ".join(f"{key} {v}" for key, v in sorted(k1_by_shape.items()))
        + "; coo_patch by (rows, cols, k): "
        + ", ".join(f"{key} {v}" for key, v in sorted(k2_by_shape.items())),
    )
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(a.nrows)).cuda()
    t_vc = median_ms(lambda: solver.apply_preconditioner(r), 20)
    t_vc_dev = median_ms(lambda: solver.apply_preconditioner(r), 20,
                         graph=True)
    say(f"V-cycle: {t_vc:.3f} ms as the solve runs it (enqueued from "
        f"Python), {t_vc_dev:.3f} ms on the device (CUDA graph replay); "
        f"solves " + ", ".join(f"{s:.3f}" for s in solve_s) + " s")

    # ---- 3b. kernels vs plain at every sparse matrix of the main path
    k_boot = cfg.coarsening_near_null_dim - 1  # the bootstrap's block width
    levels = solver.preconditioner.levels

    def sa_mat(letter, lvl, csr):
        """The float64 matrix the solver itself runs (its row-block table
        included) where it is a CappedCSR; else one built from ``csr``."""
        op = (getattr(levels[lvl], letter.lower()) if lvl < len(levels)
              else None)
        mat = getattr(op, "mat", None)
        return (mat if isinstance(mat, spmv.CappedCSR)
                else spmv.CappedCSR.from_csr(csr, "cuda", torch.float64))

    # (every A, P and R of the hierarchy that K1 ran on, and levels 0-1's)
    sa_cases = {}
    for lvl in range(h.num_levels):
        for letter, host in (("A", h.matrices), ("P", h.interpolations),
                             ("R", h.restrictions)):
            if lvl >= len(host):
                continue
            name, csr = f"{letter}{lvl}", host[lvl]
            ran = {key[2] for key in k1_by_shape if key[:2] == csr.shape}
            if not ran and lvl > 1:
                continue
            sa_cases[name] = csr.shape
            ks = {1, 8} | ran | ({k_boot} if name == "A0" else set())
            kernel_cases(
                name,
                {torch.float64: sa_mat(letter, lvl, csr),
                 torch.float32: spmv.CappedCSR.from_csr(csr, "cuda",
                                                        torch.float32)},
                args.reps, results, sorted(ks),
            )
    check({"A0", "P0", "R0", "A1", "P1", "R1"} <= set(sa_cases),
          "sparse matrices of the SA path timed: " + ", ".join(
              f"{k} {v}" for k, v in sa_cases.items()))
    # K1's and K2's excess over their bounds on the SA path
    say_excess("K1", "k1", "the SA path", k1_by_shape, results, sa_cases)
    say_excess("K2", "k2", "the SA path", k2_by_shape, results, sa_cases)

    # ---- 5. small input: card vs the plain versions on the CPU
    small = unstructured_poisson_3d(16)
    scfg = scalar_3d_config("cuda", coarsest_dim=100, dense_threshold=200)
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
    stream_recs, best, bigs, big = stream_cases(bench_recs, args.reps)
    say(f"stream read bandwidth: best float32 case {best['name']!r}: "
        f"{best['gbps']:.1f} GB/s at {STREAM_MIB} MiB per call (held in "
        f"the 50 MB L2); best at {STREAM_BIG_MIB} MiB {big['name']!r}: "
        f"{big['gbps']:.1f} GB/s ({big['ms'] * 1e3:.1f} us per call): "
        f"device memory, "
        f"{big['gbps'] / HBM_DATASHEET_GBPS:.1%} of the "
        f"{HBM_DATASHEET_GBPS:.0f} GB/s data sheet; plain version "
        f"(torch.sum) {big['plain_gbps']:.1f} GB/s "
        f"({big['plain_ms'] * 1e3:.1f} us); copy probe "
        f"({COPY_BEST}, best engine) {big['copy_gbps']:.1f} GB/s")

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
    s_k2_by_shape = dict(spmv.coo_patch_launches_by_shape)
    csr_levels = [lvl.a.mat for lvl in smg.levels
                  if isinstance(lvl.a, SparseOperator)
                  and not isinstance(lvl.a.mat, DIA)]
    check(
        s_launches["dia_spmv"] > 0
        and (not csr_levels or s_launches["csr_spmv_capped"] > 0)
        and (not any(m.n_tail for m in csr_levels)
             or s_launches["coo_patch"] > 0),
        "launches over the structured path: " + ", ".join(
            f"{k} {v}" for k, v in s_launches.items())
        + "; coo_patch by (rows, cols, k): " + ", ".join(
            f"{key} {v}" for key, v in sorted(s_k2_by_shape.items())),
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
    s_cases = set()
    for lvl, level in enumerate(smg.levels):
        mat = getattr(level.a, "mat", None)
        if isinstance(mat, spmv.CappedCSR):
            s_cases.add(f"S{lvl}")
            ran = {key[2] for key in s_k2_by_shape if key[:2] == mat.shape}
            kernel_cases(
                f"S{lvl}",
                {torch.float64: mat,
                 torch.float32: spmv.CappedCSR.from_csr(
                     mat.to_csr(), "cuda", torch.float32)},
                args.reps, results, sorted({1, 8} | ran),
            )
    say_excess("K2", "k2", "the structured path", s_k2_by_shape, results,
               s_cases)

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

    # ---- 10-12. the stage ablation, the copy probes, the primitives
    stages_entry = ablation_phase(
        {"SA A0": a_mat, "SA R0": sa_mat("R", 0, h.restrictions[0]),
         "SA A1": sa_mat("A", 1, h.matrices[1])},
        args.reps)
    dma_entry = dma_phase(args.reps)
    primitives_entry = primitives_phase(args.reps)

    # ---- results
    # both paths run float64: their errors go in the record, the SA
    # path's level-0 times beside them
    main_cases = [c for c in results
                  if (c["case"] in sa_cases or c["case"].startswith("S"))
                  and c["dtype"] == "float64"]
    a0 = next(c for c in main_cases if c["case"] == "A0" and c["k"] == 1)
    r0 = next(c for c in main_cases if c["case"] == "R0" and c["k"] == 1)
    s2 = next(c for c in main_cases if c["case"] == "S2" and c["k"] == 1)
    d0 = next(c for c in dia_results if c["case"] == "A0"
              and c["dtype"] == "float64" and c["k"] == 1)
    kernels = [
        dict(name="csr_spmv_capped", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:77",
             launches=launches[0],
             max_abs_err=max(c["err1"] for c in main_cases),
             ms=a0["k1_ms"], plain_ms=a0["k1_plain_ms"],
             bound_ms=a0["k1_bound_ms"], bound_by="bytes",
             library_ms=a0["k1_lib_ms"]),
        dict(name="coo_patch", route="cuda",
             source="tpu_amg_torch/csrc/spmv.cu",
             replaces="tpu_amg/ops/well_pallas.py:457",
             launches=launches[1],
             max_abs_err=max(c["err2"] for c in main_cases),
             ms=r0["k2_ms"], plain_ms=r0["k2_plain_ms"],
             bound_ms=r0["k2_bound_ms"], bound_by="bytes",
             library_ms=r0["k2_lib_ms"],
             # the structured path's level 2 (f64, k = 1) beside R0's tail
             launches_structured=s_launches["coo_patch"],
             level2_ms=s2["k2_ms"], level2_plain_ms=s2["k2_plain_ms"],
             level2_bound_ms=s2["k2_bound_ms"],
             level2_library_ms=s2["k2_lib_ms"]),
        # the structured path runs float64 at A0 and A1
        dict(name="dia_spmv", route="cuda",
             source="tpu_amg_torch/csrc/dia.cu",
             replaces="tpu_amg/ops/dia_pallas.py:34",
             launches=s_launches["dia_spmv"],
             max_abs_err=max(c["err"] for c in dia_results
                             if c["dtype"] == "float64"),
             ms=d0["ms"], plain_ms=d0["plain_ms"],
             bound_ms=d0["bound_ms"], bound_by="bytes",
             library_ms=d0["lib_ms"]),
        # the best float32 case past L2, where the HBM rate is a floor
        dict(name="stream_sum", route="cuda",
             source="tpu_amg_torch/csrc/stream.cu",
             replaces="tools/streambench.py:38, tools/streambench.py:96",
             launches=stream_launches,
             max_abs_err=max(r["err"] for r in stream_recs + bigs),
             case=f"{big['name']} at {STREAM_BIG_MIB} MiB",
             ms=big["ms"], plain_ms=big["plain_ms"],
             bound_ms=big["bound_ms"], bound_by="bytes",
             library_ms=big["plain_ms"]),
        stages_entry, dma_entry, primitives_entry,
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
