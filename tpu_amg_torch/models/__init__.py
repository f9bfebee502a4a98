"""Model-problem families with tuned solver presets.

Each family bundles (a) the discretized operator, (b) a right-hand side,
and (c) a :class:`tpu_amg_torch.solver.SolverConfig` tuned for that
problem class, as in the JAX package's ``tpu_amg/models``.
"""

from tpu_amg_torch.models.families import (
    ModelProblem,
    anisotropic_diffusion,
    elasticity,
    from_mfem,
    poisson,
)

__all__ = [
    "ModelProblem",
    "poisson",
    "anisotropic_diffusion",
    "elasticity",
    "from_mfem",
]
