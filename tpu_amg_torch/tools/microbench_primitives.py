"""On-chip primitive throughput: port of ``tools/microbench_primitives.py``.

Each case sums ``inner`` independent applications of one primitive into
one result (indices vary with k, so nothing folds) through
``primitive_probe`` (:mod:`tpu_amg_torch.ops.primitives`), and the cost
of one op is the marginal time between inner = LO and inner = HI over
``--tiles`` tiles, (t(HI) − t(LO)) / (tiles · (HI − LO)), as in the
harness.  Per case it prints both times, the ns per tile-op and per
element, and the bound: the op's instructions and shared-memory loads
per element over the SMs' issue and load rates, at the SM clock that
``nvidia-smi`` reports while the cases run.  The HI call is held against
the bound of its own 272 steps too: the marginal op assumes the two
calls' fixed part equal, but the HI loop hides the loads of other
blocks' prologues, so that the marginal op can read under its bound
where the call does not.  Beside them, the shared-memory wavefronts a
warp gather of the kernel takes on the timed inputs
(``primitives.shared_wavefronts``, a host model of the kernel's
addresses, on the first ``WAVEFRONT_TILES`` tiles, at inner HI), and
the design floor they imply: the bound's load term times the
wavefronts.  Cases are chosen by substrings of their keys (``add``,
``lane_gather``, ...), as in the harness.

The harness's ``xla_gather`` part, a row gather by the library ahead of
a kernel, becomes a timing of ``torch.index_select`` at its three shapes
(:147-148): a library call, not a kernel of the port.

On a CUDA device the kernels run, timed with CUDA events over the replay
of a CUDA graph of ``--reps`` calls (median of 5 replays).  On the CPU
the plain PyTorch version runs, timed with the host clock: a number of
the CPU, not of the card.

Usage: python -m tpu_amg_torch.tools.microbench_primitives [--device cuda]
           [--tiles 4096] [--reps 20] [case-substring ...]
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import threading
from typing import List, Optional

import numpy as np
import torch

from tpu_amg_torch.ops import primitives
from tpu_amg_torch.utils.timing import call_ms

TILES = 4096  # the harness's TILES
WAVEFRONT_TILES = 16  # tiles whose gathers' wavefronts are counted
# tools/microbench_primitives.py:147-148: (rows, width, gathered rows)
GATHER_SHAPES = ((2048, 128, 18752), (262144, 128, 18752), (32768, 8, 2400000))


class ClockSampler:
    """Samples the SM clock with ``nvidia-smi`` on a thread while the
    body of a ``with`` runs."""

    def __init__(self, period_s: float = 0.2):
        self.period_s = period_s
        self.samples: List[float] = []
        self._stop = threading.Event()

    def _sample(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            self.samples.append(float(out.stdout.split()[0]))

    def _loop(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.period_s)

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if not self.samples:  # a body shorter than one query
            self._sample()

    def median(self) -> Optional[float]:
        return float(np.median(self.samples)) if self.samples else None


def time_op(op: str, tiles: int, device, reps: int) -> dict:
    """Time the op at inner LO and HI on the inputs of
    ``primitives.make_inputs(op, tiles, device)``, and count its gathers'
    wavefronts on the first tiles."""
    lo, hi = primitives.LO, primitives.HI
    x, idx = primitives.make_inputs(op, tiles, device)
    t_lo = call_ms(lambda: primitives.primitive_probe(x, idx, op, lo),
                   device, reps)
    t_hi = call_ms(lambda: primitives.primitive_probe(x, idx, op, hi),
                   device, reps)
    per_ns = (t_hi - t_lo) * 1e6 / (tiles * (hi - lo))
    elements = primitives.tile_rows(op) * 128
    few = (x[:WAVEFRONT_TILES], idx[:WAVEFRONT_TILES])
    return dict(op=op, name=primitives.OPS[op].name, tiles=tiles, lo_ms=t_lo,
                hi_ms=t_hi, ns_per_op=per_ns, ns_per_element=per_ns / elements,
                wavefronts=primitives.shared_wavefronts(op, *few, hi))


def time_gathers(device, reps: int) -> List[dict]:
    """``torch.index_select`` of rows at the harness's shapes."""
    out = []
    for rows, width, nv in GATHER_SHAPES:
        src = torch.ones(rows, width, device=device)
        ids = torch.from_numpy(
            np.random.default_rng(0).integers(0, rows, nv)).to(device)
        ms = call_ms(lambda: torch.index_select(src, 0, ids), device, reps)
        gbps = nv * width * 4 / ms / 1e6
        print(f"index_select {rows}x{width} -> {nv} rows: {ms * 1e3:8.1f}us "
              f"{gbps:7.1f} GB/s eff (library call)", flush=True)
        out.append(dict(rows=rows, width=width, gathered=nv, ms=ms, gbps=gbps))
    return out


def run(argv=None):
    """The command line's work: returns (per-op records, gather records)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, default=TILES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("select", nargs="*",
                    help="run only cases whose key holds one of these")
    args = ap.parse_args(argv)

    from tpu_amg_torch.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    where = (torch.cuda.get_device_name(device) if on_card
             else "cpu (plain version, host clock)")
    print(f"# primitive_probe on {where}; {args.tiles} tiles, inner "
          f"{primitives.LO} and {primitives.HI}", flush=True)

    def want(key):
        return not args.select or any(s in key for s in args.select)

    records = []
    sampler = ClockSampler()
    with sampler if on_card else contextlib.nullcontext():
        for op in primitives.OPS:
            if want(op):
                records.append(time_op(op, args.tiles, device, args.reps))
    clock = sampler.median()
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if on_card else None)
    for rec in records:
        info = primitives.OPS[rec["op"]]
        rec["clock_mhz"] = clock
        rec["bound_ns_per_op"] = (primitives.op_bound_ns(rec["op"], sms, clock)
                                  if clock else None)
        rec["hi_bound_ms"] = (rec["tiles"] * primitives.op_bound_ns(
            rec["op"], sms, clock, primitives.HI) / 1e6 if clock else None)
        bound = (f"bound {rec['bound_ns_per_op']:.4f} ns/op: {info.what} "
                 f"({info.issue} instructions at {primitives.ISSUE_PER_CLOCK}"
                 f"/clk/SM, {info.loads} loads at {primitives.LDS_PER_CLOCK}"
                 f"/clk/SM) per element, {sms} SMs, {clock:.0f} MHz; the HI "
                 f"call's {rec['hi_bound_ms'] * 1e3:.1f}us "
                 f"({rec['hi_bound_ms'] / rec['hi_ms']:.1%} of it)"
                 if clock else "no bound off the card")
        wf = rec["wavefronts"]
        rec["floor_ns_per_op"] = (
            primitives.design_floor_ns(rec["op"], wf, sms, clock)
            if clock and wf else None)
        gathers = ("no gathers" if wf is None else
                   f"{wf:.2f} wavefronts a warp gather (host model)" + (
                       f", design floor {rec['floor_ns_per_op']:.4f} ns/op"
                       if rec["floor_ns_per_op"] else ""))
        print(f"{rec['name']:36s} lo={rec['lo_ms']:8.3f}ms "
              f"hi={rec['hi_ms']:8.3f}ms {rec['ns_per_op']:8.4f} ns/op "
              f"({rec['ns_per_element'] * 1e3:7.3f} ps/element; {bound}; "
              f"{gathers})", flush=True)
    gathers = time_gathers(device, args.reps) if want("xla_gather") else []
    return records, gathers


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
