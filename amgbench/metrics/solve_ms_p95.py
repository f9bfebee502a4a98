"""The 95th percentile of every solve of the window, host clock from
the ``solve`` call to x ready after ``torch.cuda.synchronize()``; a solve
that did not converge counts as missing (infinitely late).  None where
the tail reaches such a solve."""

import math

from amgbench.stats import percentile

LAYER = "end to end"
UNIT = "ms"
MOVES = "solve_ms_p95"


def read(record):
    p95 = percentile([s.seconds * 1e3 if s.converged else math.inf
                      for s in record.solves], 95)
    return None if math.isinf(p95) else p95
