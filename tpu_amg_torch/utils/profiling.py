"""Profiling / tracing utilities (the JAX package's
``tpu_amg/utils/profiling.py`` on PyTorch).

The reference's observability is `log`-level timing spans around
par-op construction and smooth-vector search (SURVEY.md §5).  Here:

- :func:`trace` — context manager around ``torch.profiler`` (writes a
  Chrome trace, CPU and, on a CUDA device, CUDA activities, when a log
  dir is given);
- :class:`Timer` — wall-clock span logger that synchronises a CUDA
  device on exit;
- :func:`spmv_metrics` — roofline counters (nnz/s, effective GB/s) for
  a measured SpMV.

Nothing falls back: a CUDA device that is asked for and absent raises.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

from tpu_amg_torch.device import resolve_device

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir=None, name: str = "tpu_amg", device=None):
    """torch.profiler trace of the body, inside a ``record_function``
    span named ``name``, written as a Chrome trace
    ``<log_dir>/<name>.pt.trace.json``; a no-op when ``log_dir`` is
    None.  CUDA activities are traced when ``device`` is a CUDA device
    (the body's device; CPU activities only when it is None or the
    CPU)."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(str(log_dir / f"{name}.pt.trace.json"))


class Timer:
    """Wall-clock span, logged at INFO (the reference's Instant-based
    trace!() spans, par_spmm.rs:86-90).  With a CUDA ``device`` the span
    ends after ``torch.cuda.synchronize(device)``, so it holds the work
    enqueued inside it."""

    def __init__(self, label: str, device=None):
        self.label = label
        self.device = None if device is None else resolve_device(device)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        logger.info("%s: %.3fs", self.label, self.elapsed)
        return False


def spmv_metrics(nnz: int, nrows: int, seconds: float, dtype_bytes: int = 4):
    """Roofline counters for one SpMV: nnz/s and the minimum-traffic
    effective bandwidth (values + x + y read/written once)."""
    bytes_min = dtype_bytes * (nnz + 2 * nrows)
    return {
        "nnz_per_s": nnz / seconds,
        "effective_gb_per_s": bytes_min / seconds / 1e9,
        "seconds": seconds,
    }
