"""Hand-built geometric multigrid for 1-D Poisson refinement studies.

Reference examples/simple_geometric.rs:62-113: linear-interpolation P
(½[1 2 1]), full-weighting R (¼[1 2 1]), Jacobi(0.66) smoothing,
Cholesky coarsest — the canonical mesh-independence oracle; the JAX
package's ``tpu_amg/utils/geometric.py`` on an explicit device.
"""

from __future__ import annotations

import torch

from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.preconditioners.coarse import DenseCholeskySolver
from tpu_amg_torch.preconditioners.multigrid import Level, Multigrid
from tpu_amg_torch.preconditioners.smoothers import build_smoother
from tpu_amg_torch.utils.problems import (
    geometric_interpolation_1d,
    geometric_restriction_1d,
    poisson1d,
)


def build_geometric_mg(refinements: int, coarse_elements: int = 4, *,
                       device, dtype=torch.float64):
    """Hierarchy of 1-D Poisson grids: element count doubles per level.

    Returns (finest CSR matrix, Multigrid preconditioner on ``device``).
    """
    n_elems = [coarse_elements * 2**k for k in range(refinements + 1)]
    mats = [poisson1d(ne) for ne in n_elems]
    levels = []
    for k in range(refinements, 0, -1):
        a = SparseOperator.from_csr(mats[k], device, dtype)
        n_coarse = n_elems[k - 1] - 1
        p = SparseOperator.from_csr(
            geometric_interpolation_1d(n_coarse), device, dtype,
            with_transpose=True,
        )
        r = SparseOperator.from_csr(
            geometric_restriction_1d(n_coarse), device, dtype,
            with_transpose=True,
        )
        m = build_smoother("jacobi", mats[k], device, dtype, omega=0.66)
        levels.append(Level(a=a, smoother=m, r=r, p=p))
    coarse = DenseCholeskySolver.build(mats[0], device, dtype)
    return mats[-1], Multigrid(
        levels=tuple(levels), coarse_solver=coarse, mu=1, smoothing_steps=1
    )
