"""Device timing with CUDA events, and the device-memory bound beside it."""

from __future__ import annotations

import time

import numpy as np
import torch

HBM_DATASHEET_GBPS = 3350.0  # H100 SXM data sheet


def hbm_bound_ms(nbytes: int) -> float:
    """The least time to move ``nbytes`` through device memory at the
    data sheet's rate, in ms."""
    return nbytes / HBM_DATASHEET_GBPS / 1e6


def slope_gbps(small_bytes: int, small_ms: float, big_bytes: int,
               big_ms: float):
    """The rate of the bytes that the bigger of two calls adds, (big −
    small bytes) over (big − small ms), in GB/s: a rate without the
    calls' fixed cost; None where the bigger call is not the slower."""
    if big_bytes <= small_bytes or big_ms <= small_ms:
        return None
    return (big_bytes - small_bytes) / (big_ms - small_ms) / 1e6


def l2_bound_ms(nbytes: int, gbps: float) -> float:
    """The least time to move ``nbytes`` that stay in the L2 cache, at
    ``gbps``, a read rate measured in L2 (the data sheet gives none), in
    ms."""
    return nbytes / gbps / 1e6


def _prepared(fn, reps: int, graph: bool):
    """``fn`` warmed up off the capture stream, and a function that runs
    it ``reps`` times: the replay of a CUDA graph of those calls
    (``graph``) or the calls enqueued from Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if not graph:
        def run_once():
            for _ in range(reps):
                fn()
        return run_once
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g.replay


def _reading_ms(run_once, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_once()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int, runs: int = 5, graph: bool = False) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: CUDA
    events around ``reps`` calls, divided by ``reps``; the median of
    ``runs`` such runs.

    Eager (``graph=False``) the calls are enqueued from Python back to
    back: for work shorter than the host's cost of enqueuing it this is
    the host's rate, which is what an eager caller pays.  With
    ``graph=True`` the ``reps`` calls are captured once into a CUDA graph
    and the replays are timed: the device's own time, without the host."""
    run_once = _prepared(fn, reps, graph)
    return float(np.median([_reading_ms(run_once, reps)
                            for _ in range(runs)]))


def alternating_ms(fns, reps: int, runs: int = 5) -> list:
    """Device milliseconds per call of each of ``fns``, as
    :func:`median_ms` over a CUDA graph gives them and at its cost (one
    capture and ``runs`` replays a function), the replays taken in
    turns, A B .. B A B .. : a drift of the card's clock during the run
    weighs on every function alike."""
    graphs = [_prepared(fn, reps, graph=True) for fn in fns]
    readings = [[] for _ in fns]
    for run in range(runs):
        order = range(len(fns)) if run % 2 == 0 else range(len(fns))[::-1]
        for i in order:
            readings[i].append(_reading_ms(graphs[i], reps))
    return [float(np.median(r)) for r in readings]


def call_ms(fn, device: torch.device, reps: int) -> float:
    """Milliseconds per call of ``fn``: on a CUDA device the device's
    time (:func:`median_ms` over a CUDA graph); on the CPU the host
    clock around ``reps`` calls, median of 3 (a number of the CPU, not
    of the card)."""
    if device.type == "cuda":
        return median_ms(fn, reps, graph=True)
    fn()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(times))


def solve_best(solver, b, rtol: float, maxiter: int, runs: int = 3) -> dict:
    """``solver.solve(b)`` once, then ``runs`` more, each timed on the
    host clock around a synchronised solve: the best seconds (``s``),
    with the last solve's iterations, convergence, final residual and
    ``x``."""
    def sync():
        if solver.device.type == "cuda":
            torch.cuda.synchronize(solver.device)

    x, info = solver.solve(b, rtol=rtol, maxiter=maxiter)
    sync()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        x, info = solver.solve(b, rtol=rtol, maxiter=maxiter)
        sync()
        best = min(best, time.perf_counter() - t0)
    return dict(s=best, iters=info.iters, converged=info.converged,
                final_res=info.final_res, x=x)
