"""Copy-engine bandwidth sweep: port of ``tools/dmabench.py`` (D1).

The JAX harness sweeps a hand-rolled HBM -> VMEM ring (depth D, chunk of
R rows) over a 32 MB array and sums the first 8 rows of every chunk.
Here ``dma_probe`` (:mod:`tpu_amg_torch.ops.dma`) runs the same ring on
every SM, in shared memory, with each copy engine (``bulk``: TMA bulk
copies, ``lsu``: ``cp.async`` per thread), over depth {2, 4, 8, 16} ×
unit {4, 16, 32, 64} KB pruned to the 227 KB a block can hold; a chunk
is one unit, as the harness's chunk was one DMA.  Per case it prints
the bytes in flight per SM, the time per call, GB/s and the bound (the
bytes over the card's 3,350 GB/s data sheet; the harness's 32 MB stay in
the 50 MB L2 after the first call, which that bound does not bound).

Inputs are integers 0-15 drawn from a seeded ``torch.Generator`` on the
device, so every sum is exact.  On a CUDA device the kernel runs, timed
with CUDA events over the replay of a CUDA graph of ``--reps`` calls
(median of 5 replays).  On the CPU the plain PyTorch version runs, timed
with the host clock: a number of the CPU, not of the card.

Usage: python -m tpu_amg_torch.tools.dmabench [--device cuda]
           [--total-mib 32] [--reps 50] [case-substring ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import torch

from tpu_amg_torch.ops import dma
from tpu_amg_torch.utils.timing import call_ms, hbm_bound_ms

TOTAL_MIB = 32  # the harness's TOTAL_MB (tools/dmabench.py:26)
KB = 1024


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    engine: str
    depth: int
    unit: Optional[int]  # bytes; None: a block's whole share (D2)
    n_src: int = 1
    chunk_rows: Optional[int] = None  # None: one unit
    touch_every: int = 1
    src_mib: Optional[int] = None  # None: the command line's total

    def sizes(self, total_bytes: int, blocks: int):
        """(bytes per source, unit, chunk rows) for a call."""
        src_bytes = (self.src_mib << 20) if self.src_mib else total_bytes
        unit = self.unit or dma.whole_share_unit(src_bytes * self.n_src, blocks)
        return src_bytes, unit, self.chunk_rows or unit // 512


def sweep_cases() -> List[Case]:
    """D1's sweep: engine × depth × unit, pruned to what a block holds."""
    return [Case(f"{engine} depth={depth:2d} unit={unit // KB:2d}KB",
                 engine, depth, unit)
            for engine in dma.ENGINES
            for depth in (2, 4, 8, 16)
            for unit in (4 * KB, 16 * KB, 32 * KB, 64 * KB)
            if depth * unit <= dma.MAX_RING_BYTES]


def block_count(device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return 132  # the H100's SMs: the CPU's plain version has no blocks


def make_inputs(case: Case, total_bytes: int, device, generator):
    src_bytes, _, _ = case.sizes(total_bytes, block_count(device))
    return [torch.randint(0, 16, (src_bytes // 512, 128), generator=generator,
                          device=device, dtype=torch.float32)
            for _ in range(case.n_src)]


def time_case(case: Case, total_bytes: int, device, reps: int,
              seed: int = 0) -> dict:
    """Time ``dma_probe`` on the case; returns the case's record."""
    g = torch.Generator(device=device).manual_seed(seed)
    srcs = make_inputs(case, total_bytes, device, g)
    carry = torch.zeros(8, 128, dtype=torch.float32, device=device)
    _, unit, rows = case.sizes(total_bytes, block_count(device))
    ms = call_ms(lambda: dma.dma_probe(srcs, carry, rows, case.touch_every,
                                       case.engine, case.depth, unit),
                 device, reps)
    nbytes = dma.probe_bytes(srcs)
    return dict(name=case.name, case=case, total_bytes=total_bytes,
                unit=unit, chunk_rows=rows, inflight=case.depth * unit,
                bytes=nbytes, ms=ms, gbps=nbytes / ms / 1e6,
                bound_ms=hbm_bound_ms(nbytes))


def print_record(rec: dict) -> None:
    print(f"{rec['name']:36s} inflight/SM={rec['inflight'] // KB:4d}KB "
          f"{rec['bytes'] / 2**20:7.1f}MiB {rec['ms'] * 1e3:9.1f}us "
          f"{rec['gbps']:7.1f} GB/s  bound {rec['bound_ms'] * 1e3:7.1f}us",
          flush=True)


def parse(argv, description: str, total_mib: int):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--total-mib", type=int, default=total_mib,
                    help="MiB per source where the case does not fix it")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("select", nargs="*",
                    help="run only cases whose name holds one of these")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device

    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain version, host clock)")
    return args, device, where


def run_cases(cases, args, device) -> List[dict]:
    records = []
    for case in cases:
        if args.select and not any(s in case.name for s in args.select):
            continue
        rec = time_case(case, args.total_mib << 20, device, args.reps)
        print_record(rec)
        records.append(rec)
    return records


def run(argv=None) -> List[dict]:
    """The command line's work: prints one line per case and returns the
    cases' records."""
    args, device, where = parse(argv, __doc__.splitlines()[0], TOTAL_MIB)
    print(f"# dma_probe on {where}; {args.total_mib} MiB per call, the "
          f"first 8 rows of every chunk touched", flush=True)
    return run_cases(sweep_cases(), args, device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
