"""Launches of K1, K2 and K3 (the program's ``launch_counts()`` totals,
CUDA graph replays included) counted over the window, over its solves."""

LAYER = "SpMV kernels"
UNIT = "launches"
MOVES = "solves_per_s"
TOTALS = ("csr_spmv_launches", "coo_patch_launches", "dia_spmv_launches")


def read(record):
    before, after = record.counts
    launched = sum(after[k] - before[k] for k in TOTALS)
    return launched / len(record.solves)
