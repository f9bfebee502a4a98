"""Copy-engine discriminators: port of ``tools/dmabench2.py`` (D2-D4).

The JAX harness asks where the read bandwidth goes when a kernel fetches
the bytes itself.  Its cases, each run here with both copy engines of
``dma_probe`` (:mod:`tpu_amg_torch.ops.dma`):

- ``whole`` (D2, ``k_whole``): an 8 MB array, all of it on chip, the
  first 8 rows of every 512 summed: depth 1, each block's whole share as
  its one unit;
- ``multi`` (D3, ``k_multi``): 4 sources of 16 MB, chunks of 2048 rows,
  the 4 sources' copies in flight together (ring depth 4);
- ``same`` (D4, ``k_same``): one 16 MB source, 4 chunks of 2048 rows in
  flight together, the first of each 4 touched.

The harness's 1 MB copies do not fit an SM; each copy here is a 32 KB
unit, and a chunk spans several.  Beside them it prints the harness's
read baseline (``dmabench2.py:49-55``): ``torch.sum(x, 0)`` over a 16 MB
array, a library call.  Inputs, timing and the CPU's plain version are
as in :mod:`tpu_amg_torch.tools.dmabench`.

Usage: python -m tpu_amg_torch.tools.dmabench2 [--device cuda]
           [--reps 50] [case-substring ...]
"""

from __future__ import annotations

import sys
from typing import List

import torch

from tpu_amg_torch.ops import dma
from tpu_amg_torch.tools.dmabench import KB, Case, parse, run_cases
from tpu_amg_torch.utils.timing import call_ms, hbm_bound_ms

BASELINE_MIB = 16


def cases() -> List[Case]:
    out = []
    for engine in dma.ENGINES:
        out += [
            Case(f"{engine} whole 8MB", engine, 1, None, chunk_rows=512,
                 src_mib=8),
            Case(f"{engine} multi 4x16MB", engine, 4, 32 * KB, n_src=4,
                 chunk_rows=2048, src_mib=16),
            Case(f"{engine} same 16MB", engine, 4, 32 * KB, chunk_rows=2048,
                 touch_every=4, src_mib=16),
        ]
    return out


def time_baseline(device, reps: int) -> dict:
    """``torch.sum(x, 0)`` over a 16 MB (rows, 128) array: the harness's
    read baseline."""
    x = torch.ones((BASELINE_MIB << 20) // 512, 128, device=device)
    ms = call_ms(lambda: torch.sum(x, 0), device, reps)
    nbytes = x.numel() * 4
    return dict(name=f"torch.sum(x, 0) {BASELINE_MIB}MB", bytes=nbytes,
                ms=ms, gbps=nbytes / ms / 1e6,
                bound_ms=hbm_bound_ms(nbytes))


def run(argv=None):
    """The command line's work: returns (probe records, baseline record)."""
    args, device, where = parse(argv, __doc__.splitlines()[0], BASELINE_MIB)
    print(f"# dma_probe on {where}", flush=True)
    base = time_baseline(device, args.reps)
    print(f"{base['name']:36s} {'':18s}{base['bytes'] / 2**20:7.1f}MiB "
          f"{base['ms'] * 1e3:9.1f}us {base['gbps']:7.1f} GB/s  (library "
          f"read baseline)", flush=True)
    return run_cases(cases(), args, device), base


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
