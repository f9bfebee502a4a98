"""Device time of one ``solver.preconditioner.mv`` on a right-hand side
of the run: CUDA events over a CUDA graph of 20 applies, median of 5
(:func:`amgbench.timing.device_ms`), after the window."""

from amgbench.timing import device_ms

LAYER = "V-cycle"
UNIT = "ms"
MOVES = "solves_per_s"
REPS = 20


def read(record):
    if record.device.type != "cuda":
        return None
    pc, r = record.solver.preconditioner, record.probe
    return device_ms(lambda: pc.mv(r), REPS)
