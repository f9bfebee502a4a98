"""Problem generators, checkpoints, I/O, reordering, stats, the solver
test harness, the 1-D geometric multigrid, device timing and the
visualization export.

The names of ``tpu_amg.utils.__all__`` resolve lazily from their
modules, so importing this package imports none of them.
"""

import importlib

_LAZY = {
    "poisson1d": "problems",
    "poisson2d": "problems",
    "poisson3d": "problems",
    "anisotropic_diffusion_2d": "problems",
    "elasticity_3d": "problems",
    "geometric_interpolation_1d": "problems",
    "geometric_restriction_1d": "problems",
    "matrix_stats": "stats",
    "format_stats_table": "stats",
    "test_solver": "testing",
    "approx_convergence_factor": "testing",
    "symmetry_test": "testing",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'tpu_amg_torch.utils' has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = list(_LAZY)
