"""Solves that reached rtol within maxiter, over the whole window's
seconds (first call to last x ready)."""

from amgbench.stats import rate

LAYER = "end to end"
UNIT = "solves/s"
MOVES = "solves_per_s"


def read(record):
    return rate(sum(s.converged for s in record.solves), record.window_s)
