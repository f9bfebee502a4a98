"""Process start to the first timed solve: imports, CUDA start-up,
making the inputs, the program's set-up (and in a checkout's first run
its kernels' builds), the right-hand sides, and the untimed solve that
captures the CUDA graph."""

LAYER = "end to end"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return record.setup_s
