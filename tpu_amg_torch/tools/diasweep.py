"""K3's three designs side by side on the card, and its diagonal sweep.

1. The adaptive path's fine A, ``anisotropic_diffusion_2d(512,
   epsilon=1e-3, theta=pi/6, coefficient="random")`` (262,144 rows, 9
   diagonals in 3 bands), at k = 1, 63 and 64 in float64 and float32:
   K3 as the wrapper routes it (the row-chunk design at k = 1, the
   band-tile design from k = 8 up), each design also uncounted, K1 + K2
   on the same matrix as a capped CSR and the library's SpMV / SpMM (a
   torch sparse CSR tensor ``@ X``), beside the bound (each input read
   once, each output written once, over the HBM data sheet's 3,350
   GB/s).  K3 must give the first design's bits.
2. The diagonal sweep at k = 64, float64, n = 262,144, on random data:
   offsets {0}, {-1, 0, 1}, the 9-point set of (1) and 9 consecutive
   offsets -4..4, both designs.  Per design it prints the time each
   added diagonal costs, (time - time at {0}) / (diagonals - 1), beside
   the 0.63 us that a diagonal's 2.1 MB of data adds at the data sheet's
   rate: a design that re-reads X for every diagonal pays far more.
3. The designs at k = 2 to 64 on the structured
   path's level-0 and level-1 operators (``poisson3d(100)``'s 7
   diagonals, 1,000,000 rows; the Galerkin level's 33, 125,000 rows) and
   the fine A of (1), float64 and float32: the first design, the band
   tiles and, up to k = 7, the row-chunk design, taken in turns
   (``alternating_ms``): where the wrapper's ``TILED_MIN_K`` switches
   from the row-chunk design to the band tiles; then the fixed cost of
   a launch in a graph, the row-chunk design on one diagonal of 4,096
   rows, float32, k = 1 (``floor_case``).

Times are of the device: CUDA events around the replay of a CUDA graph
of ``--reps`` calls, the median of 5 replays.  It needs a CUDA device
(exit code 2 without one).  Every launch here is uncounted or outside
any counted path.

Usage: python -m tpu_amg_torch.tools.diasweep [--reps 50]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_amg_torch.ops import dia as dia_ops
from tpu_amg_torch.utils.timing import alternating_ms, hbm_bound_ms, median_ms

FINE_N = 512  # aniso2d(512): 262,144 rows
SWEEP_K = 64
K_SWEEP = (2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 48, 63, 64)
FLOOR_ROWS = 4096  # the fixed cost's case: one diagonal of 4,096 rows
SWEEP_SETS = {
    "{0}": (0,),
    "{-1, 0, 1}": (-1, 0, 1),
    "9-point": (-513, -512, -511, -1, 0, 1, 511, 512, 513),
    "-4..4": tuple(range(-4, 5)),
}


def dia_bytes(n: int, n_diags: int, k: int, itemsize: int) -> int:
    """The bytes K3 must move: each diagonal's values, X and Y, once."""
    return (n_diags * n + 2 * n * k) * itemsize


def per_diagonal_us(times_ms: dict, sets=SWEEP_SETS) -> dict:
    """µs each added diagonal costs: (time - time at {0}) / (diagonals -
    1), for every set of more than one diagonal."""
    base = times_ms["{0}"]
    return {name: (times_ms[name] - base) * 1e3 / (len(offs) - 1)
            for name, offs in sets.items() if len(offs) > 1}


def data_us_per_diagonal(n: int, itemsize: int = 8) -> float:
    """The time a diagonal's n values take at the data sheet's rate."""
    return hbm_bound_ms(n * itemsize) * 1e3


def random_dia(offsets, n: int, dtype, seed: int):
    """A DIA on the card with standard normal values from a seeded
    generator (entries outside the matrix kept: K3 skips their reads)."""
    from tpu_amg_torch.sparse.dia import dia_from_arrays

    g = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randn((len(offsets), n), generator=g, device="cuda",
                       dtype=dtype)
    return dia_from_arrays(data, offsets, (n, n), len(offsets) * n, "cuda",
                           dtype)


def sweep(reps: int, n: int = FINE_N ** 2) -> dict:
    """The diagonal sweep: both designs' times per offset set."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n, SWEEP_K), generator=g, device="cuda",
                    dtype=torch.float64)
    out = {}
    for name, offsets in SWEEP_SETS.items():
        mat = random_dia(offsets, n, torch.float64, seed=len(offsets))
        y = dia_ops.launch_band_tiles(mat, x)
        same = torch.equal(y, dia_ops.launch_first_design(mat, x))
        out[name] = dict(
            diagonals=len(offsets),
            bands=len(dia_ops.plan_for(mat, x).bands), same=same,
            tiled_ms=median_ms(lambda: dia_ops.launch_band_tiles(mat, x),
                               reps, graph=True),
            first_ms=median_ms(lambda: dia_ops.launch_first_design(mat, x),
                               reps, graph=True),
            bound_ms=hbm_bound_ms(dia_bytes(n, len(offsets), SWEEP_K, 8)))
    return out


def say_sweep(recs: dict, n: int = FINE_N ** 2) -> str:
    """The sweep's lines: each set, then µs per added diagonal."""
    lines = [f"K3 diagonal sweep, k = {SWEEP_K}, float64, n = {n}:"]
    for name, r in recs.items():
        lines.append(
            f"  {name}: {r['diagonals']} diagonals, {r['bands']} bands: "
            f"band tiles {r['tiled_ms'] * 1e3:.2f} us, first design "
            f"{r['first_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} "
            f"us; bitwise equal {r['same']}")
    for key, label in (("tiled_ms", "band tiles"), ("first_ms",
                                                    "first design")):
        slopes = per_diagonal_us({k: r[key] for k, r in recs.items()})
        lines.append(f"  us per added diagonal, {label}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in slopes.items())
            + f" (a diagonal's data at the data sheet's rate: "
              f"{data_us_per_diagonal(n):.2f})")
    return "\n".join(lines)


def routed(k: int) -> str:
    """The design the wrapper runs at k."""
    return "band tiles" if k >= dia_ops.TILED_MIN_K else "row-chunk design"


def fine_cases(reps: int, ks=(1, 63, 64)) -> list:
    """Part 1: the designs, K1 + K2 and the library on the fine A."""
    from tpu_amg_torch.ops import spmv
    from tpu_amg_torch.sparse.dia import try_from_csr
    from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d

    a = anisotropic_diffusion_2d(FINE_N, epsilon=1e-3, theta=np.pi / 6,
                                 coefficient="random")
    n = a.nrows
    recs = []
    for dtype in (torch.float64, torch.float32):
        mat = try_from_csr(a, "cuda", dtype)
        capped = spmv.CappedCSR.from_csr(a, "cuda", dtype)
        lib = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr).to("cuda", torch.int32),
            torch.from_numpy(a.indices).to("cuda", torch.int32),
            torch.from_numpy(a.data).to("cuda", dtype), a.shape)
        for k in ks:
            g = torch.Generator(device="cuda").manual_seed(k)
            x = torch.randn((n,) if k == 1 else (n, k), generator=g,
                            device="cuda", dtype=dtype)
            y = dia_ops.dia_spmv(mat, x)
            first = dia_ops.launch_first_design(mat, x)
            tiles = dia_ops.launch_band_tiles(mat, x)
            p = dia_ops.plain_dia_spmv(mat, x)
            torch.cuda.synchronize()
            ms, first_ms, tiled_ms = alternating_ms(
                [lambda: dia_ops.dia_spmv(mat, x),
                 lambda: dia_ops.launch_first_design(mat, x),
                 lambda: dia_ops.launch_band_tiles(mat, x)], reps)
            rec = dict(
                dtype=str(dtype).replace("torch.", ""), k=k, n=n,
                diagonals=len(mat.offsets),
                bands=len(dia_ops.plan_for(mat, x).bands),
                design=routed(k),
                same=torch.equal(y, first) and torch.equal(tiles, first),
                rel_err=float((y - p).abs().max() / p.abs().max()),
                ms=ms, tiled_ms=tiled_ms, first_ms=first_ms,
                csr_ms=median_ms(lambda: spmv.spmv(capped, x), reps,
                                 graph=True),
                lib_ms=median_ms(lambda: lib @ x, reps, graph=True),
                bound_ms=hbm_bound_ms(dia_bytes(n, len(mat.offsets), k,
                                                x.element_size())))
            recs.append(rec)
    return recs


def k_sweep(reps: int, ks=K_SWEEP) -> list:
    """Part 3: the designs at every k on the structured levels 0 and 1
    and the fine A, float64 and float32, taken in turns."""
    from tpu_amg_torch.sparse.dia import try_from_csr
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.utils.problems import (anisotropic_diffusion_2d,
                                              poisson3d)

    ps = poisson3d(100)
    mg = build_structured_multigrid(ps, (100,) * 3, device="cuda",
                                    coarsest_dim=1000, dtype=torch.float64)
    fine = anisotropic_diffusion_2d(FINE_N, epsilon=1e-3, theta=np.pi / 6,
                                    coefficient="random")
    mats = {"structured A0": mg.levels[0].a.mat,
            "structured A1": mg.levels[1].a.mat,
            "fine A": try_from_csr(fine, "cuda", torch.float64)}
    recs = []
    for name, mat64 in mats.items():
        for dtype in (torch.float64, torch.float32):
            mat = mat64 if dtype == torch.float64 else mat64.astype(dtype)
            for k in ks:
                x = _randn(mat.shape[0], k, dtype, seed=k)
                fns = [lambda: dia_ops.launch_first_design(mat, x),
                       lambda: dia_ops.launch_band_tiles(mat, x)]
                if k <= dia_ops.ROW_MAX_K:
                    fns.append(lambda: dia_ops.launch_row_design(mat, x))
                outs = [fn() for fn in fns]
                same = all(torch.equal(y, outs[0]) for y in outs[1:])
                plan = dia_ops.plan_for(mat, x)
                times = alternating_ms(fns, reps)
                recs.append(dict(
                    case=name, dtype=str(dtype).replace("torch.", ""), k=k,
                    tile=plan.tile, bands=len(plan.bands), same=same,
                    first_ms=times[0], tiled_ms=times[1],
                    row_ms=times[2] if len(times) > 2 else None))
    return recs


def _randn(n: int, k: int, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n,) if k == 1 else (n, k), generator=g,
                       device="cuda", dtype=dtype)


def floor_case(reps: int) -> float:
    """The row-chunk design's fixed cost of a launch in a graph, in ms:
    one diagonal (offset 0) of ``FLOOR_ROWS`` rows, float32, k = 1."""
    mat = random_dia((0,), FLOOR_ROWS, torch.float32, seed=0)
    x = _randn(FLOOR_ROWS, 1, torch.float32, seed=0)
    return median_ms(lambda: dia_ops.launch_row_design(mat, x), reps,
                     graph=True)


def say_k_sweep(recs: list) -> str:
    lines = [f"K3's designs by k (the wrapper: the row-chunk design below "
             f"k = {dia_ops.TILED_MIN_K}, band tiles from it up):"]
    for r in recs:
        row = ("" if r["row_ms"] is None else
               f", row-chunk {r['row_ms'] * 1e3:.2f} us (band tiles / "
               f"row-chunk {r['tiled_ms'] / r['row_ms']:.2f}x)")
        lines.append(
            f"  {r['case']} {r['dtype']} k={r['k']}: first design "
            f"{r['first_ms'] * 1e3:.2f} us, band tiles (T={r['tile']}, "
            f"{r['bands']} bands) {r['tiled_ms'] * 1e3:.2f} us "
            f"({r['tiled_ms'] / r['first_ms']:.2f}x){row}; bitwise equal "
            f"{r['same']}")
    return "\n".join(lines)


def say_fine(r: dict) -> str:
    return (f"K3 fine A {r['dtype']} k={r['k']} (n {r['n']}, "
            f"{r['diagonals']} diagonals, {r['bands']} bands): K3 "
            f"({r['design']}) {r['ms'] * 1e3:.2f} us (band tiles "
            f"{r['tiled_ms'] * 1e3:.2f}, "
            f"first design {r['first_ms'] * 1e3:.2f}); K1+K2 as CSR "
            f"{r['csr_ms'] * 1e3:.2f} us; library CSR @ X "
            f"{r['lib_ms'] * 1e3:.2f} us; bound {r['bound_ms'] * 1e3:.2f} "
            f"us ({r['bound_ms'] / r['ms']:.1%} of it); bitwise equal to the "
            f"first design {r['same']}; max rel err {r['rel_err']:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("diasweep: no CUDA device", file=sys.stderr)
        return 2
    ok = True
    for rec in fine_cases(args.reps):
        print(say_fine(rec), flush=True)
        ok &= rec["same"]
    recs = sweep(args.reps)
    print(say_sweep(recs), flush=True)
    ok &= all(r["same"] for r in recs.values())
    recs = k_sweep(args.reps)
    print(say_k_sweep(recs), flush=True)
    ok &= all(r["same"] for r in recs)
    print(f"K3's row-chunk design, fixed cost of a launch in a graph (one "
          f"diagonal, {FLOOR_ROWS} rows, float32, k = 1): "
          f"{floor_case(args.reps) * 1e3:.2f} us", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
