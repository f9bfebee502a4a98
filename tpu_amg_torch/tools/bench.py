"""SpMV throughput benchmark: the port of the JAX package's ``bench.py``.

Measures y = A·x in nnz a second on two ~1M-row systems against a
roofline whose rate is a STREAM triad, and prints one JSON line with
``bench.py``'s eight keys, computed by its formulas (:func:`summary`).
Part by part:

- :func:`triad_bandwidth` (``bench.py:27-48``): ``v ← v + 0.5·y`` over
  two f32 arrays of 32·2²⁰ elements (4 MiB each on the CPU), 3·n·4 bytes
  a repetition.  The JAX tool's triad is an XLA elementwise op, not a
  Pallas kernel: a torch op is its counterpart.  ``stream_sum``'s read
  rate on 1 GiB a call (:func:`tpu_amg_torch.tools.bench_vcycle.stream_bandwidth`)
  is printed beside it for comparison and used in no key.
- The structured system (``bench.py:84-196``): ``poisson3d(--grid)``
  (100 on the card, 48 on the CPU, ``bench.py:100``) as an f32 DIA,
  timed in three formats: ``"dia"``, K3 (``ops/dia.py`` ``dia_spmv``,
  the row-chunk design at k = 1), the counterpart of both the JAX
  ``"dia"`` (XLA) and ``"pallas-dia"`` (``bench.py:162-192``), since on
  the card the port's DIA apply is K3; ``"csr"``, K1 + K2 on the
  matrix's :class:`CappedCSR`; ``"ell"``, the :class:`ELL` container,
  whose capped CSR is the CSR's own.  ``fmt`` is the fastest, the first
  in that order on a tie.  Then the DIA with bf16 values under f32
  vectors (``bench.py:154-158``), K3's (bf16, f32) pair.  The JAX
  tool's environment switches (``TPU_AMG_BENCH_ELL``,
  ``TPU_AMG_BENCH_NO_PALLAS``) are not ported: every format is timed on
  every run.
- The FEM system (``bench.py:213-250``):
  ``unstructured_fem_system(--side)`` (1024 on the card, 128 on the
  CPU, ``bench.py:218``), whose WELL or hybrid apply on the TPU is K1 +
  K2 here: a :class:`CappedCSR` at (f32, f32), then its values in bf16
  under f32 vectors, (bf16, f32).
- The JSON line (``bench.py:196-205``, ``:238-244``, ``:256-266``):
  :func:`summary`.

Every apply is timed at a fixed x of ones (``bench.py:104``, ``:227``):
CUDA events over the replay of a CUDA graph of ``--reps`` applies,
median of 5 (:func:`tpu_amg_torch.utils.timing.call_ms`), the method of
PERF.md's kernel table.  ``bench.py`` chains u ← A·u from ones instead;
on ``poisson3d`` that grows by up to ‖A‖∞ = 12 a step, so in f32 it
overflows to inf, and then NaN, within a few dozen steps.  The f32 DIA
of ``poisson3d(100)`` moves ~36 MB a call and its bf16-value form ~22
MB, both under the H100's 50 MB L2, while the triad's rate is the
device memory's: the stderr lines give each apply's bytes beside the
card's L2 size.  Neither matrix has a row past K1's cap of 64 (both
have at most ~20 entries a row), so K2 has no tail to patch and
launches no time here; the stderr lines give each matrix's tail rows.

Nothing falls back: a part that fails fails the run (``bench.py``'s
``try/except`` around its Pallas and FEM parts and its retry are not
ported).  ``--device`` defaults to ``cuda`` and raises without a card;
on the CPU (``--device cpu``) every apply is its plain version and
every time the host clock's, a CPU number.

Usage: python -m tpu_amg_torch.tools.bench [--grid 100] [--side 1024] [--reps 200] [--device cpu]
"""

import argparse
import json
import sys
import time

import torch

from tpu_amg_torch.ops.dia import plain_dia_spmv
from tpu_amg_torch.ops.spmv import CappedCSR, k1_bytes, plain_spmv, spmv
from tpu_amg_torch.sparse.dia import DIA, try_from_csr
from tpu_amg_torch.sparse.ell import ELL
from tpu_amg_torch.tools.bench_elasticity import dia_bytes

METRIC = "spmv_throughput_3d_poisson_1M"
KEYS = ("metric", "value", "unit", "vs_baseline", "bf16_values_gnnzs",
        "unstructured_gnnzs", "unstructured_bf16v_gnnzs",
        "unstructured_vs_target")
TARGET = 0.70  # BASELINE.md: SpMV at >= 70% of the roofline
FORMATS = ("dia", "csr", "ell")
# the timed applies: the formats, then the bf16-value DIA and the FEM
# system at (f32, f32) and (bf16, f32)
APPLIES = FORMATS + ("dia_bf16v", "fem", "fem_bf16v")
# elements of each triad array: 2 x 128 MiB on the card (bench.py:33),
# 2 x 4 MiB on the CPU
TRIAD_ELEMS = {"cuda": 32 << 20, "cpu": 1 << 20}
GRID = {"cuda": 100, "cpu": 48}
SIDE = {"cuda": 1024, "cpu": 128}


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def triad_bandwidth(device, reps: int) -> float:
    """Bytes a second of the triad ``v ← v + 0.5·y`` (f32), 3·n·4 bytes a
    repetition, over ``reps`` chained repetitions."""
    from tpu_amg_torch.utils.timing import call_ms

    n = TRIAD_ELEMS[device.type]
    v = torch.ones(n, dtype=torch.float32, device=device)
    y = torch.full((n,), 2.0, dtype=torch.float32, device=device)
    ms = call_ms(lambda: v.add_(y, alpha=0.5), device, reps)
    return 3 * n * 4 / (ms * 1e-3)


def summary(*, nnz: int, n: int, seconds: float, bf16_seconds: float,
            bandwidth: float, fem_nnz: int, fem_n: int, fem_seconds: float,
            fem_bf16_seconds: float) -> dict:
    """``bench.py``'s JSON line from the best structured apply's seconds
    (``seconds``), the bf16-value DIA's, the FEM system's at (f32, f32)
    and (bf16, f32), and the triad's bytes a second: nnz a second over
    70% of the roofline ``nnz · bandwidth / (4·nnz + 8·n)``, values once
    plus x and y once (``bench.py:196-205``, ``:238-244``); each number
    rounded to 4 places (``:256-266``)."""
    rate = nnz / seconds
    roofline = nnz * bandwidth / (4 * nnz + 8 * n)
    fem_rate = fem_nnz / fem_seconds
    fem_roofline = fem_nnz * bandwidth / (4 * fem_nnz + 8 * fem_n)
    return {
        "metric": METRIC,
        "value": round(rate / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(rate / (TARGET * roofline), 4),
        "bf16_values_gnnzs": round(nnz / bf16_seconds / 1e9, 4),
        "unstructured_gnnzs": round(fem_rate / 1e9, 4),
        "unstructured_bf16v_gnnzs": round(fem_nnz / fem_bf16_seconds / 1e9,
                                          4),
        "unstructured_vs_target": round(fem_rate / (TARGET * fem_roofline),
                                        4),
    }


def matrices(a_struct, a_fem, device) -> dict:
    """The timed matrices on ``device``, by :data:`APPLIES` name, from the
    host CSRs of the structured and the FEM system."""
    dia = try_from_csr(a_struct, device, torch.float32)
    if dia is None:
        raise ValueError(f"{a_struct} is no DIA of at most 32 diagonals")
    fem = CappedCSR.from_csr(a_fem, device, torch.float32)
    return dict(dia=dia,
                csr=CappedCSR.from_csr(a_struct, device, torch.float32),
                ell=ELL.from_csr(a_struct, device, torch.float32),
                dia_bf16v=dia.astype(torch.bfloat16), fem=fem,
                fem_bf16v=fem.astype(torch.bfloat16))


def apply(mat, x: torch.Tensor) -> torch.Tensor:
    """y = A x: K3 for a DIA, K1 + K2 for a capped CSR or an ELL."""
    return spmv(mat, x) if isinstance(mat, CappedCSR) else mat.mv(x)


def plain_apply(mat, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`apply`, on any device."""
    if isinstance(mat, DIA):
        return plain_dia_spmv(mat, x)
    return plain_spmv(mat.capped if isinstance(mat, ELL) else mat, x)


def apply_bytes(mat) -> int:
    """The bytes an apply at f32 vectors must move, each once: K3's
    diagonals, x and y
    (:func:`tpu_amg_torch.tools.bench_elasticity.dia_bytes`); K1's capped
    values and indices, row pointers, x and y
    (:func:`tpu_amg_torch.ops.spmv.k1_bytes`)."""
    if isinstance(mat, DIA):
        return dia_bytes(mat, 4)
    return k1_bytes(mat.capped if isinstance(mat, ELL) else mat, 1,
                    torch.float32)


def measure(a_struct, a_fem, device, reps: int) -> dict:
    """Time every apply of :data:`APPLIES` on the host CSRs ``a_struct``
    (structured) and ``a_fem`` (FEM) and the triad on ``device``; print
    the diagnostics on stderr.  Returns {"json": :func:`summary`'s line,
    "record": the diagnostics (JSON-ready), "matrices": the timed
    matrices by name}."""
    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.tools.bench_vcycle import stream_bandwidth
    from tpu_amg_torch.utils.timing import call_ms

    device = resolve_device(device)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    mats = matrices(a_struct, a_fem, device)
    say(f"# matrices built in {time.perf_counter() - t0:.1f} s")
    applies = {}
    for name in APPLIES:
        mat = mats[name]
        x = torch.ones(mat.shape[1], dtype=torch.float32, device=device)
        ms = call_ms(lambda: apply(mat, x), device, reps)
        nnz = a_fem.nnz if name.startswith("fem") else a_struct.nnz
        applies[name] = dict(
            kernel="K3" if name.startswith("dia") else "K1 + K2", ms=ms,
            bytes=apply_bytes(mat), gnnzs=nnz / (ms * 1e-3) / 1e9)
    fmt = min(FORMATS, key=lambda f: applies[f]["ms"])
    bw = triad_bandwidth(device, reps)
    stream_bw = stream_bandwidth(device, max(reps // 10, 2))

    out = summary(nnz=a_struct.nnz, n=a_struct.nrows,
                  seconds=applies[fmt]["ms"] * 1e-3,
                  bf16_seconds=applies["dia_bf16v"]["ms"] * 1e-3,
                  bandwidth=bw, fem_nnz=a_fem.nnz, fem_n=a_fem.nrows,
                  fem_seconds=applies["fem"]["ms"] * 1e-3,
                  fem_bf16_seconds=applies["fem_bf16v"]["ms"] * 1e-3)
    where = (torch.cuda.get_device_name(device) if on_card
             else "cpu (plain versions, host clock)")
    l2 = (torch.cuda.get_device_properties(device).L2_cache_size if on_card
          else None)
    roofline = a_struct.nnz * bw / (4 * a_struct.nnz + 8 * a_struct.nrows)
    tails = {"poisson": mats["csr"].n_tail_rows,
             "fem": mats["fem"].n_tail_rows}
    record = dict(device=where, l2_bytes=l2, triad_gbps=bw / 1e9,
                  stream_sum_gbps=stream_bw / 1e9, fmt=fmt,
                  poisson=dict(n=a_struct.nrows, nnz=a_struct.nnz,
                               tail_rows=tails["poisson"]),
                  fem=dict(n=a_fem.nrows, nnz=a_fem.nnz,
                           tail_rows=tails["fem"]),
                  applies=applies, json=out)

    say(f"# device={where} n={a_struct.nrows} nnz={a_struct.nnz} fmt={fmt} "
        + " ".join(f"{f}={applies[f]['ms']:.6f}ms" for f in FORMATS)
        + f" bw={bw / 1e9:.1f}GB/s roofline={roofline / 1e9:.2f}Gnnz/s")
    say(f"# bf16 values: dia={applies['dia_bf16v']['ms']:.6f}ms; "
        f"unstructured n={a_fem.nrows} nnz={a_fem.nnz} "
        f"fem={applies['fem']['ms']:.6f}ms "
        f"fem_bf16v={applies['fem_bf16v']['ms']:.6f}ms")
    say(f"# triad {bw / 1e9:.1f} GB/s (the roofline's rate, "
        f"{3 * TRIAD_ELEMS[device.type] * 4} B a repetition); stream_sum "
        f"{stream_bw / 1e9:.1f} GB/s (for comparison, in no key)")
    say("# bytes a call: " + ", ".join(
        f"{k} ({v['kernel']}) {v['bytes']}" for k, v in applies.items())
        + (f"; the card's L2 {l2} B" if on_card else "; no L2 on the CPU"))
    say(f"# K2 tail rows: poisson {tails['poisson']}, fem {tails['fem']}"
        + ("; no row passes K1's cap, so K2 has nothing to patch"
           if not any(tails.values()) else ""))
    return dict(json=out, record=record, matrices=mats)


def run(argv=None) -> dict:
    """The command line's work: builds both systems, :func:`measure`s
    them and prints the JSON line last on stdout; returns
    :func:`measure`'s dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=None,
                    help="poisson3d's grid (default: 100 on the card, 48 on "
                         "the CPU)")
    ap.add_argument("--side", type=int, default=None,
                    help="unstructured_fem_system's side (default: 1024 on "
                         "the card, 128 on the CPU)")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.utils.problems import poisson3d, unstructured_fem_system

    device = resolve_device(args.device)
    grid = args.grid or GRID[device.type]
    side = args.side or SIDE[device.type]
    t0 = time.perf_counter()
    a_struct = poisson3d(grid)
    a_fem = unstructured_fem_system(side)
    say(f"# poisson3d({grid}) and unstructured_fem_system({side}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    res = measure(a_struct, a_fem, device, args.reps)
    print(json.dumps(res["json"]), flush=True)
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
