"""Host clock around the program's set-up call (the preset's ``build``:
``AMGSolver.setup`` or ``build_structured_multigrid`` and the solver),
ending in ``torch.cuda.synchronize()``."""

LAYER = "host setup"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return record.spans["amg_setup_s"]
