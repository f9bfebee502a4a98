"""The fine operator's apply, ``solver.op.mv``, against its roofline:
the least time its bytes take (:func:`amgbench.roofline.spmv_bytes` of
the benchmark's own matrix, in the configuration's dtype) over its device
time, timed as ``vcycle_ms`` over a graph of 50 applies.  The bound is
the HBM data sheet's rate where the bytes pass the 50 MB L2, else the L2
read rate the benchmark's probe measures in the same run; the result line
says which under ``roofline_bound``."""

import torch

from amgbench import roofline
from amgbench.timing import device_ms, l2_read_gbps

LAYER = "SpMV kernels"
UNIT = "%"
MOVES = "solves_per_s"
REPS = 50


def read(record):
    if record.device.type != "cuda":
        return None
    op, x = record.solver.op, record.probe
    itemsize = getattr(torch, record.config["dtype"]).itemsize
    n = len(record.problem["indptr"]) - 1
    nbytes = roofline.spmv_bytes(len(record.problem["data"]), n, itemsize,
                                 itemsize)
    ms = device_ms(lambda: op.mv(x), REPS)
    gbps, name = roofline.bound(nbytes, lambda: l2_read_gbps(record.device))
    record.notes["roofline_bound"] = {
        "fine_spmv": {"bytes": nbytes, "gbps": gbps, "bound": name, "ms": ms}}
    return roofline.share_pct(nbytes, gbps, ms)
