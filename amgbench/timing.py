"""Device time of a call, and the L2 cache's read rate.

A frozen copy of the arithmetic of ``tpu_amg_torch.utils.timing.median_ms``
with ``graph=True``: the call warmed up three times on a side stream,
``reps`` calls captured in one CUDA graph, the replay timed with CUDA
events ``runs`` times, the median of the readings over ``reps``.
"""

from __future__ import annotations

import statistics

import torch


def device_ms(fn, reps: int, runs: int = 5) -> float:
    """Milliseconds of device time per call of ``fn``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    readings = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / reps)
    return float(statistics.median(readings))


def slope_gbps(small_bytes: int, small_ms: float, big_bytes: int,
               big_ms: float):
    """GB/s of the bytes the bigger call adds over the smaller: a rate
    without the calls' fixed cost; None where the bigger is not slower."""
    if big_bytes <= small_bytes or big_ms <= small_ms:
        return None
    return (big_bytes - small_bytes) / (big_ms - small_ms) / 1e6


def _sum_probe(src):
    """``torch.sum`` of ``src``: reads its bytes."""
    out = torch.empty((), dtype=src.dtype, device=src.device)
    return (lambda: torch.sum(src, dim=0, out=out)), src.numel() * 4


def _copy_probe(src):
    """``Tensor.copy_`` of ``src``: reads and writes its bytes."""
    dst = torch.empty_like(src)
    return (lambda: dst.copy_(src)), src.numel() * 8


# each probe at two sizes (MiB of float32) that both fit the 50 MB L2 with
# all they touch
PROBES = ((_sum_probe, (16, 32)), (_copy_probe, (8, 16)))
PROBE_REPS = 50


def l2_read_gbps(device) -> float:
    """The best rate at which plain PyTorch sums or copies a buffer held
    in the L2 cache: each probe's slope between its two sizes, each size
    timed by :func:`device_ms` over back-to-back calls that find it in L2."""
    rates = []
    for probe, sizes in PROBES:
        ms, nbytes = [], []
        for mib in sizes:
            src = torch.ones(mib * 2 ** 18, dtype=torch.float32, device=device)
            fn, moved = probe(src)
            ms.append(device_ms(fn, PROBE_REPS))
            nbytes.append(moved)
        rate = slope_gbps(nbytes[0], ms[0], nbytes[1], ms[1])
        if rate is not None:
            rates.append(rate)
    if not rates:
        raise RuntimeError("the L2 probe read no rate: a bigger buffer was "
                           "not slower than a smaller one")
    return max(rates)
