"""Device timing with CUDA events."""

from __future__ import annotations

import numpy as np
import torch


def median_ms(fn, reps: int, runs: int = 5, graph: bool = False) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: CUDA
    events around ``reps`` calls, divided by ``reps``; the median of
    ``runs`` such runs.

    Eager (``graph=False``) the calls are enqueued from Python back to
    back: for work shorter than the host's cost of enqueuing it this is
    the host's rate, which is what an eager caller pays.  With
    ``graph=True`` the ``reps`` calls are captured once into a CUDA graph
    and the replays are timed: the device's own time, without the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run_once = g.replay
    else:
        def run_once():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_once()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))
