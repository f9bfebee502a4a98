"""Streaming-read bandwidth probe: port of ``tools/streambench.py``.

Runs the JAX harness's case list through ``stream_sum``
(:mod:`tpu_amg_torch.ops.stream`) and prints, per case, the tiles, the
bytes read per tile, the time per call and the read bandwidth in GB/s.
Inputs are integers 0-99 drawn from a seeded ``torch.Generator`` on the
device, ``--total-mib`` MiB per call (32 MiB, the harness's ``TOTAL``,
by default).  The harness's "+cost" case is left out: it repeats the
case before it with a cost-estimate hint to XLA, and CUDA has no such
hint.

On a CUDA device the kernel runs, timed with CUDA events over the
replay of a CUDA graph of ``--reps`` calls (median of 5 replays).  On
the CPU the plain PyTorch version runs, timed with the host clock: a
number of the CPU, not of the card.

Usage: python -m tpu_amg_torch.tools.streambench [--device cuda]
           [--total-mib 32] [--reps 50] [case-substring ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List

import torch

from tpu_amg_torch.ops import stream
from tpu_amg_torch.utils.timing import call_ms

TOTAL_MIB = 32


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    layout: str  # "case" (run_case) or "wide" (run_wide)
    n_in: int
    rows: int
    width: int
    dtype: torch.dtype

    def tiles(self, total_bytes: int) -> int:
        return max(total_bytes // self.tile_bytes, 1)

    @property
    def tile_bytes(self) -> int:
        """Bytes read per tile, over all inputs."""
        itemsize = torch.tensor([], dtype=self.dtype).element_size()
        return self.n_in * self.rows * self.width * itemsize


# tools/streambench.py:154-179, without the "+cost" case
CASES = [
    Case("f32 1in rows=512", "case", 1, 512, 128, torch.float32),
    Case("f32 1in rows=64", "case", 1, 64, 128, torch.float32),
    Case("f32 1in rows=2048", "case", 1, 2048, 128, torch.float32),
    Case("int8 1in rows=512", "case", 1, 512, 128, torch.int8),
    Case("int8 1in rows=2048", "case", 1, 2048, 128, torch.int8),
    Case("f32 7in rows=64 (WELL-shape)", "case", 7, 64, 128, torch.float32),
    Case("f32 7in rows=512", "case", 7, 512, 128, torch.float32),
    Case("int8 7in rows=512", "case", 7, 512, 128, torch.int8),
    Case("wide f32 1in 8x8192", "wide", 1, 8, 8192, torch.float32),
    Case("wide f32 1in 8x32768", "wide", 1, 8, 32768, torch.float32),
    Case("wide f32 1in 64x8192", "wide", 1, 64, 8192, torch.float32),
    Case("wide int8 1in 32x8192", "wide", 1, 32, 8192, torch.int8),
    Case("wide f32 7in 8x4096", "wide", 7, 8, 4096, torch.float32),
]


def make_inputs(case: Case, total_bytes: int, device,
                generator: torch.Generator) -> List[torch.Tensor]:
    """The case's ``n_in`` inputs as (tiles, rows, width) views."""
    tiles = case.tiles(total_bytes)
    out = []
    stacked = case.layout == "case"
    shape = ((tiles, case.rows, case.width) if stacked
             else (case.rows, tiles * case.width))
    for _ in range(case.n_in):
        arr = torch.randint(0, 100, shape, generator=generator, device=device,
                            dtype=case.dtype)
        out.append(arr if stacked else stream.wide_layout(arr, case.width))
    return out


def time_case(case: Case, total_bytes: int, device, reps: int,
              seed: int = 0) -> dict:
    """Time ``stream_sum`` on the case; returns the case's record."""
    g = torch.Generator(device=device).manual_seed(seed)
    inputs = make_inputs(case, total_bytes, device, g)
    carry = torch.zeros(8, 128, dtype=torch.float32, device=device)
    ms = call_ms(lambda: stream.stream_sum(inputs, carry), device, reps)
    tiles = case.tiles(total_bytes)
    nbytes = tiles * case.tile_bytes
    return dict(name=case.name, tiles=tiles, tile_bytes=case.tile_bytes,
                bytes=nbytes, ms=ms, gbps=nbytes / (ms * 1e-3) / 1e9)


def run(argv=None) -> List[dict]:
    """The command line's work: prints one line per case and returns the
    cases' records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--total-mib", type=int, default=TOTAL_MIB,
                    help="MiB read per call (default: the harness's 32)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("select", nargs="*",
                    help="run only cases whose name holds one of these")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device

    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain version, host clock)")
    print(f"# stream_sum on {where}; {args.total_mib} MiB per call",
          flush=True)
    records = []
    for case in CASES:
        if args.select and not any(s in case.name for s in args.select):
            continue
        rec = time_case(case, args.total_mib << 20, device, args.reps)
        print(f"{case.name:44s} tiles={rec['tiles']:6d} "
              f"blk={rec['tile_bytes'] // 1024:5d}KB "
              f"{rec['ms'] * 1e3:9.1f}us  {rec['gbps']:7.1f} GB/s", flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
