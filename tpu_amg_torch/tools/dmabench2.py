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
array, a library call.  Inputs, timing, bounds and the CPU's plain
version are as in :mod:`tpu_amg_torch.tools.dmabench`: D2's 8 MB and
D4's 16 MB fit in the 50 MB L2, and their bound is their bytes over the
L2 read rate measured first (``dmabench.l2_read_rate``); D3's 64 MB
are bound by the HBM data sheet.  Then the probe's fixed cost
(:func:`fixed_cost`): its time on one 4 KB unit a block, the share of a
few-us call that no copy rate can touch.

Usage: python -m tpu_amg_torch.tools.dmabench2 [--device cuda]
           [--reps 50] [case-substring ...]
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from tpu_amg_torch.ops import dma
from tpu_amg_torch.tools.dmabench import (KB, Case, block_count, in_l2,
                                          l2_read_rate, parse, print_l2,
                                          print_record, run_cases)
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


def fixed_cost(device, reps: int) -> dict:
    """The probe's fixed cost: ``dma_probe`` on a source of one 4 KB
    unit a block (depth 1, every chunk touched), timed as the cases
    are."""
    blocks = block_count(device)
    g = torch.Generator(device=device).manual_seed(0)
    src = torch.randint(0, 16, (blocks * 8, 128), generator=g, device=device,
                        dtype=torch.float32)
    carry = torch.zeros(8, 128, dtype=torch.float32, device=device)

    ms = call_ms(lambda: dma.dma_probe([src], carry, 8, 1, "bulk", 1,
                                       dma.HEAD_BYTES), device, reps)
    return dict(bytes=dma.probe_bytes([src]), ms=ms)


def run(argv=None, l2: Optional[dict] = None):
    """The command line's work: returns (probe records, baseline record,
    fixed-cost record).  On the card the cases that fit in L2 are bound
    by ``l2`` (``dmabench.l2_read_rate``), measured here unless given."""
    args, device, where = parse(argv, __doc__.splitlines()[0], BASELINE_MIB)
    print(f"# dma_probe on {where}", flush=True)
    base = time_baseline(device, args.reps)
    print(f"{base['name']:36s} {'':18s}{base['bytes'] / 2**20:7.1f}MiB "
          f"{base['ms'] * 1e3:9.1f}us {base['gbps']:7.1f} GB/s  (library "
          f"read baseline)", flush=True)
    if l2 is None and in_l2(8 << 20, device):
        l2 = l2_read_rate(device, args.reps)
    if l2 is not None:
        print_l2(l2)
    records = run_cases(cases(), args, device, l2)
    for rec in records:
        print_record(rec)
    fixed = fixed_cost(device, args.reps)
    print(f"fixed cost: {fixed['ms'] * 1e3:.2f}us a call on one 4 KB unit a "
          f"block ({fixed['bytes'] // KB} KB)", flush=True)
    return records, base, fixed


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
