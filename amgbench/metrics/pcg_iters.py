"""The mean of ``SolveInfo.iters`` over the window's solves."""

LAYER = "solve loop"
UNIT = "iters"
MOVES = "solves_per_s"


def read(record):
    return sum(s.iters for s in record.solves) / len(record.solves)
