"""tpu_amg_torch: the smoothed-aggregation AMG solver on PyTorch and CUDA.

The PyTorch port of the JAX package ``tpu_amg`` (which stays the
reference), laid out module for module like it.  Setup (partitioning,
interpolation, Galerkin products) is host numpy plus the port's own C++
in ``tpu_amg_torch/csrc/amg_native.cc``; the bootstrap and the solve run on an
explicit device, and every sparse apply there goes through the
hand-written CUDA kernels of :mod:`tpu_amg_torch.ops.spmv` (their plain
PyTorch versions run on the CPU).

The top-level names are those of ``tpu_amg.__all__``, resolved lazily:
importing the package imports neither torch nor a kernel module.

This package imports neither ``jax`` nor ``tpu_amg``.
"""

import importlib

__version__ = "0.1.0"

# name -> the module that defines it (a submodule itself where the
# module is the name)
_LAZY = {
    "errors": "tpu_amg_torch.errors",
    "sparse": "tpu_amg_torch.sparse",
    "AMGSolver": "tpu_amg_torch.solver",
    "SolverConfig": "tpu_amg_torch.solver",
    "Hierarchy": "tpu_amg_torch.hierarchy",
    "HierarchyConfig": "tpu_amg_torch.hierarchy",
    "AdaptiveConfig": "tpu_amg_torch.adaptivity",
    "LinearOperator": "tpu_amg_torch.linop",
    "SparseOperator": "tpu_amg_torch.linop",
    "DenseOperator": "tpu_amg_torch.linop",
    "ComposedOperator": "tpu_amg_torch.linop",
    "ScaledIdentity": "tpu_amg_torch.linop",
    "aslinearoperator": "tpu_amg_torch.linop",
    "cast_operator": "tpu_amg_torch.precision",
    "cast_preconditioner": "tpu_amg_torch.precision",
    "MixedPrecision": "tpu_amg_torch.precision",
}


def __getattr__(name):
    # lazy top-level conveniences (importing the package stays cheap)
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'tpu_amg_torch' has no attribute {name!r}")
    mod = importlib.import_module(module)
    return mod if module.endswith("." + name) else getattr(mod, name)


__all__ = list(_LAZY)
