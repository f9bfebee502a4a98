"""V-cycle time benchmark: the port of the JAX package's
``bench_vcycle.py`` (BASELINE.md: "V-cycle wall-time speed-of-light
per-kernel").

Builds the gather-free structured SA multigrid on a 3-D Poisson problem
(default 64³ = 262,144 dofs, float32: DIA levels through K3) and times
one V-cycle on the device (CUDA events over the replay of a CUDA graph
of ``--reps`` cycles, median of 5), in float32 and in the
``"bf16_values"`` and ``"bf16"`` modes, beside its speed-of-light
estimate: every level's 9 SpMV-equivalents of minimum traffic (4 bytes
a stored value and 8 a row), summed, over the read bandwidth that
``stream_sum`` (S1/S2) measures on 1 GiB a call on the card, 4 MiB on
the CPU (the best float32 case of the stream probe, ``wide f32 1in
64x8192``).  Then the
float32 PCG solve of A x = 1 to rtol 1e-6 (at most 100 iterations) with
that cycle and with its ``"bf16_values"`` cast, each best of 3 after a
first solve (``AMGSolver.solve``: a CUDA graph an iteration on the
card).

Prints the JAX tool's stderr lines and one JSON line with its keys
(``vs_baseline`` = the estimate / the measured cycle).  On the CPU
(``--device cpu``) every time is the host clock's, a CPU number.

Usage: python -m tpu_amg_torch.tools.bench_vcycle [--grid 64] [--reps 200] [--device cpu]
"""

import argparse
import json
import sys
import time

import torch

MODES = ("bf16_values", "bf16")
BW_CASE = "wide f32 1in 64x8192"  # the stream probe's best float32 case
# bytes a stream_sum call reads: 1 GiB on the card, a few MiB on the CPU
STREAM_BYTES = {"cuda": 1 << 30, "cpu": 4 << 20}
RTOL = 1e-6
MAXITER = 100


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stream_bandwidth(device, reps: int) -> float:
    """Bytes a second that ``stream_sum`` reads on ``STREAM_BYTES`` a
    call."""
    from tpu_amg_torch.tools import streambench

    case = next(c for c in streambench.CASES if c.name == BW_CASE)
    rec = streambench.time_case(case, STREAM_BYTES[device.type], device, reps)
    return rec["bytes"] / (rec["ms"] * 1e-3)


def sol_bytes(mg) -> int:
    """The JAX tool's minimum traffic of one cycle: each level 9 SpMV
    passes (Chebyshev degree 3 pre + post smoothing = 6, the residual,
    two transfers) of 4 bytes a stored value and 8 a row; a dense level
    stores n² values."""
    from tpu_amg_torch.linop import SparseOperator

    total = 0
    for lvl in mg.levels:
        n = lvl.a.shape[0]
        nnz = lvl.a.mat.nnz if isinstance(lvl.a, SparseOperator) else n * n
        total += 9 * (4 * nnz + 8 * n)
    return total


def build(n_grid: int, device, lambda_starts=None):
    """(A, the float32 structured multigrid) of poisson3d(n_grid),
    coarsest 1500; ``lambda_starts`` as in
    :func:`tpu_amg_torch.structured.build_structured_multigrid`."""
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.utils.problems import poisson3d

    a = poisson3d(n_grid)
    return a, build_structured_multigrid(
        a, (n_grid,) * 3, device=device, coarsest_dim=1500,
        dtype=torch.float32, lambda_starts=lambda_starts)


def pcg_solver(a, mg, device):
    """An :class:`AMGSolver` around ``mg`` and the float32 operator of
    the JAX tool's solve (DIA up to 160 diagonals, density 8.0)."""
    from tpu_amg_torch.linop import SparseOperator
    from tpu_amg_torch.solver import AMGSolver, SolverConfig

    op = SparseOperator.from_csr(a, device, torch.float32,
                                 dia_max_diags=160, dia_max_density=8.0)
    return AMGSolver(a, mg, config=SolverConfig(dtype=torch.float32,
                                                device=str(device)), op=op)


def run(argv=None) -> dict:
    """The command line's work: returns {"json": the printed line's
    object, "solves": {"f32": ..., "bf16_values": ...}, "multigrid": the
    float32 cycle, "bandwidth_gbps": ...}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.precision import cast_preconditioner
    from tpu_amg_torch.utils.timing import call_ms, solve_best

    device = resolve_device(args.device)
    n_grid = args.grid
    t0 = time.time()
    a, mg = build(n_grid, device)
    say(f"# setup {time.time() - t0:.1f}s: {len(mg.levels) + 1} levels, "
        f"fine n={a.nrows} nnz={a.nnz}")

    x = torch.ones(a.nrows, dtype=torch.float32, device=device)
    best = call_ms(lambda: mg.mv(x), device, args.reps)
    best16 = {}
    for mode in MODES:
        mg16 = cast_preconditioner(mg, mode)
        best16[mode] = call_ms(lambda: mg16.mv(x), device, args.reps)
        say(f"# vcycle[{mode}]={best16[mode]:.3f}ms")

    bw = stream_bandwidth(device, max(args.reps // 10, 2))
    sol = sol_bytes(mg) / bw * 1e3
    say(f"# vcycle={best:.3f}ms sol={sol:.3f}ms bw={bw / 1e9:.0f}GB/s")

    b = torch.ones(a.nrows, dtype=torch.float32, device=device)
    solves = {}
    for name, tag, m in (("f32", "", mg),
                         ("bf16_values", "[bf16_values cycle]",
                          cast_preconditioner(mg, "bf16_values"))):
        s = solve_best(pcg_solver(a, m, device), b, RTOL, MAXITER)
        say(f"# full PCG solve{tag}: {s['s'] * 1e3:.1f}ms, {s['iters']} "
            f"iters, res {s['final_res']:.2e}")
        solves[name] = s
    out = {
        "metric": f"vcycle_wall_time_3d_poisson_{n_grid}cubed",
        "value": round(best, 4),
        "unit": "ms",
        "vs_baseline": round(sol / best, 4),
    }
    for mode, b16 in best16.items():
        out[f"value_{mode}"] = round(b16, 4)
    print(json.dumps(out), flush=True)
    return dict(json=out, solves=solves, multigrid=mg,
                bandwidth_gbps=bw / 1e9, sol_ms=sol)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
