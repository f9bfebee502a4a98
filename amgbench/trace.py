"""The traced stretch of a ``--trace 1`` run, and what is read from it.

``torch.profiler`` (CPU and CUDA activities) records a stretch of the
window's solves inside a ``record_function`` span named
:data:`STRETCH`; the Chrome trace it exports is read back here.  The
stretch's length is that span's; the device's busy time is the union of
the kernel, copy and set intervals inside it; each idle gap is named by
the innermost host event that covers its middle (what the host was doing
while the device waited).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import json
import os
import tempfile

STRETCH = "amgbench.traced_stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function"}
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[host activity, seconds], ...], most time first


class Stretch:
    """Starts the profiler and the stretch's span on :meth:`start`, ends
    both on :meth:`stop`; :meth:`read` summarizes the exported trace.
    Made in set-up: the profiler's first start in a process takes seconds
    (its device tracing starts up), so it is started and stopped once
    there, around nothing, and starts at once inside the window."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.span = None
        warm = self._profiler()
        warm.start()
        torch.cuda.synchronize()
        warm.stop()

    def _profiler(self):
        t = self.torch
        return t.profiler.profile(activities=[
            t.profiler.ProfilerActivity.CPU, t.profiler.ProfilerActivity.CUDA])

    @property
    def started(self) -> bool:
        return self.prof is not None

    @property
    def active(self) -> bool:
        return self.span is not None

    def start(self) -> None:
        self.prof = self._profiler()
        self.prof.start()
        self.span = self.torch.profiler.record_function(STRETCH)
        self.span.__enter__()

    def stop(self) -> None:
        if self.span is None:
            return
        self.span.__exit__(None, None, None)
        self.span = None
        self.prof.stop()

    def read(self) -> "Summary | None":
        """The stretch's summary, or None where nothing was traced."""
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        return summarize(events)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list) -> "Summary | None":
    """Reads a Chrome trace's ``traceEvents`` (times in µs): None where
    it holds no stretch span."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH
             and str(e.get("cat", "")).lower() == "user_annotation"]
    if not spans:
        return None
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    by_name = collections.Counter()
    intervals = []
    hosts = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                intervals.append((s, t))
                by_name[str(e.get("name", "?"))[:NAME_CHARS]] += (t - s) / 1e6
        elif cat in HOST_CATS and e.get("name") != STRETCH:
            hosts.append((s, t, str(e.get("name", "?"))[:NAME_CHARS]))
    busy = _union(intervals)
    gaps, cursor = [], w0
    for s, t in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if cursor < w1:
        gaps.append((cursor, w1))
    by_host = collections.Counter()
    hosts.sort()
    # a sweep over the gaps' middles: the heap holds the host events begun
    # so far, latest start on top; one that ended before the middle can
    # cover no later middle either, and the latest-begun event that still
    # covers the middle is the innermost
    heap, i = [], 0
    for s, t in gaps:
        mid = (s + t) / 2
        while i < len(hosts) and hosts[i][0] <= mid:
            heapq.heappush(heap, (-hosts[i][0], hosts[i][1], hosts[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host between profiled calls"
        by_host[name] += (t - s) / 1e6
    return Summary(window_s=(w1 - w0) / 1e6,
                   busy_s=sum(t - s for s, t in busy) / 1e6,
                   device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
                   idle_gaps=[[k, v] for k, v in by_host.most_common(TOP)])
