"""Sweep K1's row-block size S on the SA path's own matrices.

K1 (``csr_spmv_capped``) is compiled for one row-block size,
``spmv.BLOCK_ENTRIES``: blocks of at most S entries and S / 2 rows, a
thread block of S / 4 threads each.  This probe builds K1's source once
more for each S of ``--entries`` (``nvcc -DROWBLOCK_ENTRIES=S`` into
``libamg_kernels_s<S>.so``, all side by side), cuts each matrix's table
for that S (:func:`tpu_amg_torch.ops.spmv.row_blocks`), and times K1 on:

- the sparse matrices of the SA path: ``AMGSolver.setup`` on
  ``unstructured_poisson_3d(--side)`` with the scalar 3-D config
  (:func:`tpu_amg_torch.solver.scalar_3d_config`), then one PCG solve;
  the A, P and R of levels 0 and 1 in float64, at k = 1 and at every k
  K1 ran them with in that setup and solve;
- the harnesses' FEM 1M matrix (``unstructured_fem_system(--fem-side)``)
  in float32, k = 1.

Each S is held against K1's plain version first.  Per case it prints
each S's time per call beside K1's first design (the ablation's
``rowgroup``, k = 1), the library's SpMV or SpMM (a torch sparse CSR
tensor of the capped part ``@ x``) and the bound: the bytes K1 must move
over the card's 3,350 GB/s data sheet.  Each time is taken twice.
*Warm*: back-to-back calls on one matrix, which stays in the 50 MB L2
if it fits.  *Cold*: the calls cycle over copies of the matrix and x
that pass ``COLD_BYTES`` together, so that each call reads them from
device memory, as in a V-cycle, which streams other data between two
applies of one matrix.  Last, for each S, K1's time on the SA path:
over the timed (rows, cols, k), the launches of the setup and the solve
times the time per call.

On a CUDA device the kernels run, timed with CUDA events over the replay
of a CUDA graph of at least ``--reps`` calls (median of 5 replays).  On
the CPU the plain PyTorch version runs, whatever the table, timed with
the host clock on one copy: a number of the CPU, not of the card.

Usage: python -m tpu_amg_torch.tools.rowblocks [--device cuda]
           [--side 64] [--fem-side 1024] [--reps 50]
           [--entries 256 512 1024 2048]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import math
import sys
import time

import numpy as np
import torch

from tpu_amg_torch.ops import spmv, spmv_stages
from tpu_amg_torch.ops._build import build_cuda_library
from tpu_amg_torch.utils.timing import call_ms, hbm_bound_ms

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
COLD_BYTES = 200_000_000  # four times the card's 50 MB L2
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def kernel_libs(entries) -> dict:
    """S -> K1's library compiled for row blocks of S, built side by
    side."""
    def build(s):
        path = build_cuda_library(f"libamg_kernels_s{s}.so", spmv.SOURCE,
                                  defines=[f"ROWBLOCK_ENTRIES={s}"])
        return spmv.bind_kernel_lib(path, s)

    with concurrent.futures.ThreadPoolExecutor(len(entries)) as pool:
        return dict(zip(entries, pool.map(build, entries)))


def sa_matrices(side: int, device: torch.device):
    """The A, P and R of levels 0 and 1 of the SA path on
    ``unstructured_poisson_3d(side)`` (label -> host CSR), and K1's
    launches by (rows, cols, k) over its setup and one solve."""
    from tpu_amg_torch.solver import AMGSolver, scalar_3d_config
    from tpu_amg_torch.utils.problems import unstructured_poisson_3d

    a = unstructured_poisson_3d(side)
    spmv.reset_launch_counts()
    solver = AMGSolver.setup(a, scalar_3d_config(device.type))
    b = np.random.default_rng(0).standard_normal(a.nrows)
    solver.solve(b, rtol=1e-6, maxiter=200)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(spmv.csr_spmv_launches_by_shape)
    h = solver.hierarchy
    mats = {}
    for lvl in range(min(h.num_levels, 2)):
        for letter, host in (("A", h.matrices), ("P", h.interpolations),
                             ("R", h.restrictions)):
            if lvl < len(host):
                mats[f"{letter}{lvl}"] = host[lvl]
    return mats, launches


def copies(mat: spmv.CappedCSR, x: torch.Tensor, n: int) -> list:
    """``n`` (matrix, x) pairs in separate memory, the first the given
    one; the row-block tables are shared."""
    out = [(mat, x)]
    for _ in range(n - 1):
        out.append((dataclasses.replace(
            mat, indptr=mat.indptr.clone(), indices=mat.indices.clone(),
            data=mat.data.clone(), _rows=None), x.clone()))
    return out


def warm_cold_ms(call, pairs, device, reps):
    """ms per ``call(mat, x)``: warm on the first pair alone, cold
    cycling over every pair."""
    warm = call_ms(lambda: call(*pairs[0]), device, reps)
    cycle = itertools.cycle(pairs)
    cold = call_ms(lambda: call(*next(cycle)), device,
                   len(pairs) * math.ceil(reps / len(pairs)))
    return warm, cold


def sweep_case(label, csr, dtype, k, launches, libs, entries, device, reps):
    """Time every S on one matrix at k columns beside ``rowgroup`` (k = 1)
    and the library; returns the records."""
    mat = spmv.CappedCSR.from_csr(csr, device, dtype)
    rng = np.random.default_rng(k)
    shape = (csr.shape[1],) if k == 1 else (csr.shape[1], k)
    x = torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)
    ref = spmv.plain_csr_spmv_capped(mat, x)
    scale = max(float(ref.abs().max()), 1e-300)
    nbytes = spmv.k1_bytes(mat, k)
    n_copies = (math.ceil(COLD_BYTES / nbytes) if device.type == "cuda"
                else 1)
    pairs = copies(mat, x, n_copies)
    base = dict(matrix=label, dtype=str(dtype).replace("torch.", ""), k=k,
                shape=tuple(csr.shape), launches=launches,
                bound_ms=hbm_bound_ms(nbytes))
    designs = []  # (name, call, its (matrix, x) pairs, what it records)
    if k == 1:
        designs.append(("rowgroup", lambda m, v: spmv_stages.csr_spmv_stages(
            m, v, "rowgroup"), pairs, {}))
    libs_csr = [(torch.sparse_csr_tensor(
        m.indptr.to(torch.int32), m.indices, m.data, m.shape), v)
        for m, v in pairs]
    designs.append(("library", lambda m, v: m @ v, libs_csr, {}))
    for s in entries:
        table = spmv.block_table(mat.indptr.cpu().numpy(), device, s)
        mine = [(dataclasses.replace(m, **table), v) for m, v in pairs]
        if device.type == "cuda":
            fn = getattr(libs[s], f"csr_spmv_capped_{_SUFFIX[dtype]}")
            call = (lambda fn: lambda m, v: spmv.launch_csr_spmv_capped(
                fn, m, v, k))(fn)
        else:
            call = spmv.plain_csr_spmv_capped
        err = float((call(*mine[0]) - ref).abs().max()) / scale
        if err > TOL[dtype]:
            raise RuntimeError(f"{label} k={k} S={s}: rel err {err:.2e}")
        designs.append((f"S={s}", call, mine,
                        dict(blocks=mine[0][0].n_blocks, err=err)))
    out = []
    for design, call, args, rec in designs:
        warm, cold = warm_cold_ms(call, args, device, reps)
        out.append(dict(base, **rec, design=design, warm_ms=warm,
                        cold_ms=cold))
    print(f"{label:7s} {base['dtype']} k={k} {csr.shape} nnz {csr.nnz}, "
          f"{launches} K1 launches on the SA path, {n_copies} copies cold; "
          f"bound {base['bound_ms'] * 1e3:.2f} us; us warm / cold: "
          + "; ".join(f"{r['design']} {r['warm_ms'] * 1e3:.2f} / "
                      f"{r['cold_ms'] * 1e3:.2f}" for r in out), flush=True)
    return out


def run(argv=None):
    """The command line's work: returns (records, K1's time on the SA
    path by S: {S: (warm ms, cold ms)})."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--fem-side", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--entries", type=int, nargs="+",
                    default=[256, 512, 1024, 2048])
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.utils.problems import unstructured_fem_system

    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain version, host clock)")
    t0 = time.perf_counter()
    libs = kernel_libs(args.entries) if device.type == "cuda" else {}
    t_build = time.perf_counter() - t0
    mats, launches = sa_matrices(args.side, device)
    print(f"# csr_spmv_capped row-block sweep on {where}: S = "
          f"{args.entries} built in {t_build:.1f} s; SA path on "
          f"unstructured_poisson_3d({args.side}) set up and solved in "
          f"{time.perf_counter() - t0 - t_build:.1f} s; K1 launches by "
          f"(rows, cols, k): {sorted(launches.items())}", flush=True)
    records = sweep_case(f"fem{args.fem_side}",
                         unstructured_fem_system(args.fem_side),
                         torch.float32, 1, 0, libs, args.entries, device,
                         args.reps)
    for label, csr in mats.items():
        ks = {1} | {key[2] for key in launches if key[:2] == csr.shape}
        for k in sorted(ks):
            records += sweep_case(label, csr, torch.float64, k,
                                  launches.get((*csr.shape, k), 0), libs,
                                  args.entries, device, args.reps)
    timed = {(*r["shape"], r["k"]) for r in records if r["launches"]}
    on_path = {}
    for s in args.entries:
        mine = [r for r in records if r["design"] == f"S={s}"]
        on_path[s] = tuple(sum(r["launches"] * r[key] for r in mine)
                           for key in ("warm_ms", "cold_ms"))
    print(f"K1 on the SA path, launches x time per call over "
          f"{sum(launches[key] for key in timed)} of "
          f"{sum(launches.values())} launches, ms warm / cold: "
          + "; ".join(f"S={s} {w:.3f} / {c:.3f}"
                      for s, (w, c) in on_path.items()), flush=True)
    return records, on_path


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
