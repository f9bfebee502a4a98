"""Stage ablation of K1: port of the WELL ablation harnesses of ``tools/``.

Builds ``unstructured_fem_system(side)`` (the harnesses' matrix: the
jittered-Delaunay 2-D FEM Laplacian, RCM-ordered; side 1024 is the 1M
matrix of ``tools/wellablate2.py``), splits it into a ``CappedCSR``
(K1's cap and group size), draws x from a numpy seed, and times
``csr_spmv_stages`` in each mode (:mod:`tpu_amg_torch.ops.spmv_stages`).
Per mode it prints the time per call, Gnnz/s, GB/s of the bytes the
mode must move, those bytes, and the bound: the bytes over the card's
3,350 GB/s data sheet.

On a CUDA device the kernel runs, timed with CUDA events over the replay
of a CUDA graph of ``--reps`` calls (median of 5 replays).  On the CPU
the plain PyTorch version runs, timed with the host clock: a number of
the CPU, not of the card.

Usage: python -m tpu_amg_torch.tools.wellablate [--device cuda]
           [--side 1024] [--dtype f32] [--reps 200] [mode ...]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List

import numpy as np
import torch

from tpu_amg_torch.ops import spmv_stages
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.utils.timing import call_ms, hbm_bound_ms

DTYPES = {"f32": torch.float32, "f64": torch.float64}


def make_x(n: int, device, dtype, seed: int = 0) -> torch.Tensor:
    """x from a numpy seed, as the harnesses draw it."""
    x = np.random.default_rng(seed).normal(size=n)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def time_modes(mat: CappedCSR, x: torch.Tensor, modes, reps: int,
               label: str = "") -> List[dict]:
    """Time each mode on (mat, x); print one line per mode and return
    the records."""
    records = []
    for mode in modes:
        ms = call_ms(lambda: spmv_stages.csr_spmv_stages(mat, x, mode),
                     x.device, reps)
        nbytes = spmv_stages.stage_bytes(mat, mode)
        rec = dict(mode=mode, matrix=label, dtype=str(x.dtype), ms=ms,
                   bytes=nbytes, gnnzs=mat.data.numel() / ms / 1e6,
                   gbps=nbytes / ms / 1e6,
                   bound_ms=hbm_bound_ms(nbytes))
        print(f"{label:12s} {mode:15s} {ms * 1e3:9.2f}us "
              f"{rec['gnnzs']:7.2f} Gnnz/s {rec['gbps']:7.1f} GB/s "
              f"{nbytes / 1e6:7.1f} MB  bound {rec['bound_ms'] * 1e3:7.2f}us",
              flush=True)
        records.append(rec)
    return records


def run(argv=None):
    """The command line's work: returns (records, matrix, x)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("modes", nargs="*",
                    help=f"modes to run (default: all of {spmv_stages.MODES})")
    args = ap.parse_args(argv)
    modes = args.modes or list(spmv_stages.MODES)
    for mode in modes:
        if mode not in spmv_stages.MODES:
            ap.error(f"unknown mode {mode!r}")

    from tpu_amg_torch.device import resolve_device
    from tpu_amg_torch.utils.problems import unstructured_fem_system

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    csr = unstructured_fem_system(args.side)
    dtype = DTYPES[args.dtype]
    mat = CappedCSR.from_csr(csr, device, dtype)
    x = make_x(csr.nrows, device, dtype)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain version, host clock)")
    print(f"# csr_spmv_stages on {where}; unstructured_fem_system"
          f"({args.side}): n={csr.nrows} nnz={csr.nnz} (capped "
          f"{mat.data.numel()}, tail {mat.n_tail}), group {mat.group}, "
          f"{args.dtype}; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    records = time_modes(mat, x, modes, args.reps, f"fem{args.side}")
    return records, mat, x


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
