"""Copy-engine bandwidth sweep: port of ``tools/dmabench.py`` (D1).

The JAX harness sweeps a hand-rolled HBM -> VMEM ring (depth D, chunk of
R rows) over a 32 MB array and sums the first 8 rows of every chunk.
Here ``dma_probe`` (:mod:`tpu_amg_torch.ops.dma`) runs the same ring on
every SM, in shared memory, with each copy engine (``bulk``: TMA bulk
copies, ``lsu``: ``cp.async`` per thread), over depth {2, 4, 8, 16} ×
unit {4, 16, 32, 64} KB pruned to the 227 KB a block can hold; a chunk
is one unit, as the harness's chunk was one DMA.  Per case it prints
the bytes in flight per SM, the time per call, GB/s and the bound with
its share of the time.  Bytes past the L2 cache are bound by the card's
3,350 GB/s data sheet; bytes that fit in it (the harness's 32 MB stay
in the 50 MB L2 after the first call) by the best read rate measured in
L2 in the same process, without a call's fixed cost
(:func:`l2_read_rate`: the slope of the time between 16 and 32 MiB a
call, the larger of ``stream_sum``'s and this sweep's best), and the
data-sheet time is printed beside, labelled as such.

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

from tpu_amg_torch.ops import dma, stream
from tpu_amg_torch.tools import streambench
from tpu_amg_torch.utils.timing import (call_ms, hbm_bound_ms, l2_bound_ms,
                                        slope_gbps)

TOTAL_MIB = 32  # the harness's TOTAL_MB (tools/dmabench.py:26)
L2_MIB = (16, 32)  # MiB a call between which the L2 read rate is measured
L2_PAIRS = 3  # timings of each size, taken in turns
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


def in_l2(nbytes: int, device) -> bool:
    """Whether ``nbytes`` fit in the card's L2 cache."""
    return (device.type == "cuda" and nbytes <= torch.cuda.get_device_properties(
        device).L2_cache_size)


def bound(nbytes: int, device, l2: Optional[dict]) -> dict:
    """The bound of a call that moves ``nbytes``: over ``l2``'s rate
    where they fit in L2 (and ``l2`` is known), else over the data
    sheet's HBM rate; with the data sheet's time beside."""
    hbm = hbm_bound_ms(nbytes)
    if l2 is not None and in_l2(nbytes, device):
        return dict(bound_ms=l2_bound_ms(nbytes, l2["gbps"]), hbm_bound_ms=hbm,
                    bound_rate=f"L2 {l2['gbps']:.1f} GB/s ({l2['origin']})")
    return dict(bound_ms=hbm, hbm_bound_ms=hbm, bound_rate="HBM data sheet")


def time_case(case: Case, total_bytes: int, device, reps: int,
              seed: int = 0, l2: Optional[dict] = None) -> dict:
    """Time ``dma_probe`` on the case; returns the case's record, with
    its bound over ``l2``'s rate where its bytes fit in L2."""
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
                **bound(nbytes, device, l2))


def copy_grid(case: Case, total_bytes: int, blocks: int) -> int:
    """The blocks of ``dma_probe``'s grid for the case at
    ``total_bytes`` a source, on a card of ``blocks`` SMs."""
    src_bytes, unit, _ = case.sizes(total_bytes, blocks)
    return min(blocks, case.n_src * -(-src_bytes // unit))


def stream_grid(case: streambench.Case, total_bytes: int, blocks: int):
    """``stream_sum``'s grid (parts, blocks) for the case at
    ``total_bytes`` a call, on a card of ``blocks`` SMs."""
    itemsize = torch.tensor([], dtype=case.dtype).element_size()
    return stream.launch_plan(case.tiles(total_bytes), case.rows, case.width,
                              itemsize, case.n_in, blocks)


def l2_read_rate(device, reps: int, copies: Optional[List[dict]] = None
                 ) -> dict:
    """The best read rate measured in L2 here, without a call's fixed
    cost: the slope of the time between ``L2_MIB`` = 16 and 32 MiB a
    call, (t(32) − t(16)) / 16 MiB, of ``stream_sum``'s single-input
    float32 cases and of each copy engine's best case of the sweep at 32
    MiB (``copies``, records already timed there, or timed now); the
    largest.  Each case is timed at the two sizes in turns,
    ``L2_PAIRS`` times, and each size's median taken, so that both see
    the card in one state.  Only cases whose grid is the same at both
    sizes count: the
    16 MiB more then add bytes to every block, where a grid that grows
    with the bytes (``stream_sum`` with fewer tiles than SMs) would put
    more SMs' rate into the slope.  {"gbps", "origin", "call_gbps": that
    case's whole-call rate at 32 MiB, its fixed cost included,
    "slopes": {case: GB/s}}."""
    small, big = (mib << 20 for mib in L2_MIB)
    sms = block_count(device)
    if copies is None:
        copies = [time_case(c, big, device, reps) for c in sweep_cases()]
    def in_turns(time_at):
        runs = [(time_at(small), time_at(big)) for _ in range(L2_PAIRS)]
        return [sorted((run[i] for run in runs),
                       key=lambda r: r["ms"])[L2_PAIRS // 2] for i in (0, 1)]

    pairs = []  # (name, record at 16 MiB, record at 32 MiB)
    for engine in dma.ENGINES:
        top = max((r for r in copies if r["case"].engine == engine),
                  key=lambda r: r["gbps"])["case"]
        if copy_grid(top, small, sms) == copy_grid(top, big, sms):
            pairs.append((f"dma_probe {top.name}", *in_turns(
                lambda n: time_case(top, n, device, reps))))
    for case in streambench.CASES:
        if (case.dtype == torch.float32 and case.n_in == 1
                and stream_grid(case, small, sms) == stream_grid(case, big,
                                                                 sms)):
            pairs.append((f"stream_sum {case.name}", *in_turns(
                lambda n: streambench.time_case(case, n, device, reps))))
    rates = [(slope_gbps(lo["bytes"], lo["ms"], hi["bytes"], hi["ms"]), name,
              hi) for name, lo, hi in pairs]
    rates = [r for r in rates if r[0] is not None]
    if not rates:
        raise RuntimeError("no case read 32 MiB slower than 16 MiB: no L2 "
                           "read rate")
    gbps, name, hi = max(rates, key=lambda r: r[0])
    return dict(gbps=gbps, call_gbps=hi["gbps"],
                origin=f"{name}, the slope from {L2_MIB[0]} to {L2_MIB[1]} "
                       f"MiB a call",
                slopes={name: rate for rate, name, _ in rates})


def print_record(rec: dict) -> None:
    print(f"{rec['name']:36s} inflight/SM={rec['inflight'] // KB:4d}KB "
          f"{rec['bytes'] / 2**20:7.1f}MiB {rec['ms'] * 1e3:9.1f}us "
          f"{rec['gbps']:7.1f} GB/s  bound {rec['bound_ms'] * 1e3:7.2f}us "
          f"({rec['bound_ms'] / rec['ms']:.0%} of the time; "
          f"{rec['bound_rate']}" + (
              f"; the HBM data sheet's {rec['hbm_bound_ms'] * 1e3:.2f}us, "
              f"not a floor in L2)" if rec["bound_rate"].startswith("L2")
              else ")"), flush=True)


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


def run_cases(cases, args, device, l2: Optional[dict] = None) -> List[dict]:
    records = []
    for case in cases:
        if args.select and not any(s in case.name for s in args.select):
            continue
        rec = time_case(case, args.total_mib << 20, device, args.reps, l2=l2)
        records.append(rec)
    return records


def print_l2(l2: dict) -> None:
    print(f"# L2 read rate {l2['gbps']:.1f} GB/s: {l2['origin']} (its whole "
          f"call at {L2_MIB[1]} MiB {l2['call_gbps']:.1f} GB/s, fixed cost "
          f"included), the bound of the cases whose bytes fit in L2; the "
          f"slopes: " + ", ".join(f"{name} {rate:.1f}" for name, rate
                                  in l2["slopes"].items()), flush=True)


def run(argv=None) -> List[dict]:
    """The command line's work: prints one line per case and returns the
    cases' records (on the card, where the sweep's bytes fit in L2, with
    ``l2``, the L2 read rate their bounds use)."""
    args, device, where = parse(argv, __doc__.splitlines()[0], TOTAL_MIB)
    print(f"# dma_probe on {where}; {args.total_mib} MiB per call, the "
          f"first 8 rows of every chunk touched", flush=True)
    records = run_cases(sweep_cases(), args, device)
    if records and in_l2(records[0]["bytes"], device):
        # the whole sweep at 32 MiB gives the copy probe's best cases
        whole = args.total_mib == L2_MIB[1] and not args.select
        l2 = l2_read_rate(device, args.reps, records if whole else None)
        print_l2(l2)
        for rec in records:
            rec.update(bound(rec["bytes"], device, l2), l2=l2)
    for rec in records:
        print_record(rec)
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
