"""The device's idle share of the window outside the traced stretch:
1 − (device busy seconds a solve) × (solves outside the stretch) /
(the window's seconds outside it).  The busy seconds a solve are the
union of kernel, copy and set intervals in the profiler's trace over the
solves the stretch holds; the rest of the window runs without the
profiler, whose host overhead would lengthen the gaps.  None where the
trace shows no device time or either part holds no solve."""

LAYER = "device"
UNIT = "%"
MOVES = "solves_per_s"


def read(record):
    t = record.trace
    outside = len(record.solves) - record.stretch_solves
    seconds = record.window_s - record.stretch_s
    if (t is None or t.busy_s <= 0 or record.stretch_solves <= 0
            or outside <= 0 or seconds <= 0):
        return None
    busy_per_solve = t.busy_s / record.stretch_solves
    return 100.0 * (1.0 - busy_per_solve * outside / seconds)
