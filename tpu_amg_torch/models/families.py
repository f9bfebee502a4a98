"""Problem families: operator + rhs + tuned solver preset.

The JAX package's presets (``tpu_amg/models/families.py``) on the
port's :class:`SolverConfig`, with the device named by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tpu_amg_torch.solver import SolverConfig
from tpu_amg_torch.sparse import CSR
from tpu_amg_torch.utils import problems


@dataclasses.dataclass
class ModelProblem:
    name: str
    matrix: CSR
    rhs: np.ndarray
    solver_config: SolverConfig
    coords: Optional[np.ndarray] = None

    def setup_solver(self):
        from tpu_amg_torch.solver import AMGSolver

        return AMGSolver.setup(self.matrix, self.solver_config)


def poisson(n: int, dim: int = 2, device: str = "cuda") -> ModelProblem:
    """Structured Poisson (5/7-point): constant near-null, scalar SA with
    candidate dim 1-2 suffices; chebyshev smoothing."""
    gen = {1: problems.poisson1d, 2: problems.poisson2d, 3: problems.poisson3d}
    a = gen[dim](n)
    cfg = SolverConfig(
        coarsening_near_null_dim=8,
        interp_near_null_dim=1 if dim < 3 else 2,
        smoothing_iters=10,
        coarsening_factor=8.0,
        smoother="chebyshev",
        smoothing_steps=2,
        device=device,
    )
    return ModelProblem("poisson%dd" % dim, a, np.ones(a.nrows), cfg)


def anisotropic_diffusion(
    n: int,
    epsilon: float = 1e-3,
    theta: float = np.pi / 6,
    coefficient: str = "constant",
    device: str = "cuda",
) -> ModelProblem:
    """Rotated anisotropic diffusion: needs a richer near-null space and
    stronger coarsening along the weak direction; SA candidate dim 4."""
    a = problems.anisotropic_diffusion_2d(
        n, epsilon=epsilon, theta=theta, coefficient=coefficient
    )
    cfg = SolverConfig(
        coarsening_near_null_dim=16,
        interp_near_null_dim=4,
        smoothing_iters=20,
        coarsening_factor=8.0,
        smoother="chebyshev",
        smoothing_steps=3,
        device=device,
    )
    return ModelProblem("aniso2d", a, np.ones(a.nrows), cfg)


def elasticity(n: int, device: str = "cuda") -> ModelProblem:
    """3-D linear elasticity (block_size 3): 6 rigid-body modes → SA
    candidate dim 6, block-aware coarsening."""
    a = problems.elasticity_3d(n)
    cfg = SolverConfig(
        coarsening_near_null_dim=12,
        interp_near_null_dim=6,
        smoothing_iters=15,
        coarsening_factor=4.0,
        smoother="chebyshev",
        smoothing_steps=2,
        device=device,
    )
    return ModelProblem("elasticity3d", a, np.ones(a.nrows), cfg)


def from_mfem(directory, name: str = "system", device: str = "cuda",
              **config_overrides) -> ModelProblem:
    """Load an MFEM dump (reference utils.rs:269-350 format)."""
    from tpu_amg_torch.utils.io import load_mfem_linear_system

    sys_ = load_mfem_linear_system(directory, name)
    cfg = SolverConfig(device=device, **config_overrides)
    rhs = (
        sys_.rhs[:, 0]
        if sys_.rhs.size
        else np.ones(sys_.matrix.nrows)
    )
    return ModelProblem(
        name, sys_.matrix, rhs, cfg, coords=sys_.coords
    )
