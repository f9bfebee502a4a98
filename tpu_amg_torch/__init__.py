"""tpu_amg_torch: the smoothed-aggregation AMG solver on PyTorch and CUDA.

The PyTorch port of the JAX package ``tpu_amg`` (which stays the
reference), laid out module for module like it.  Setup (partitioning,
interpolation, Galerkin products) is host numpy plus the port's own C++
in ``tpu_amg_torch/csrc/amg_native.cc``; the bootstrap and the solve run on an
explicit device, and every sparse apply there goes through the
hand-written CUDA kernels of :mod:`tpu_amg_torch.ops.spmv` (their plain
PyTorch versions run on the CPU).

This package imports neither ``jax`` nor ``tpu_amg``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level conveniences (importing the package stays cheap)
    if name in ("AMGSolver", "SolverConfig"):
        from tpu_amg_torch import solver

        return getattr(solver, name)
    raise AttributeError(f"module 'tpu_amg_torch' has no attribute {name!r}")


__all__ = ["AMGSolver", "SolverConfig"]
