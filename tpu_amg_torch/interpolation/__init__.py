"""Interpolation (coarsening) algorithms: smoothed aggregation and
classical CR+LS (reference src/interpolation/).

``InterpolationConfig`` dispatches between the two families
(reference interpolation/mod.rs:28-60; the reference's default is
Classical, and so is the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tpu_amg_torch.interpolation.classical import ClassicalConfig
from tpu_amg_torch.interpolation.sa import (
    AggregationConfig,
    GalerkinCoarse,
    block_jacobi_smooth,
    smooth_interpolation,
    smoothed_aggregation,
)


@dataclasses.dataclass
class InterpolationConfig:
    """Dispatch enum analog (interpolation/mod.rs:28-60).

    kind: "aggregation" (smoothed aggregation) or "classical" (compatible
    relaxation + least-squares interpolation).  The reference defaults to
    classical (mod.rs:56-60).
    """

    kind: str = "classical"
    aggregation: AggregationConfig = dataclasses.field(
        default_factory=AggregationConfig
    )
    classical: Optional[ClassicalConfig] = None  # default built on init

    def __post_init__(self):
        if self.classical is None:
            self.classical = ClassicalConfig()

    def build(self, a, near_null, nn_weights) -> GalerkinCoarse:
        if self.kind == "aggregation":
            return self.aggregation.build(a, near_null, nn_weights)
        if self.kind == "classical":
            return self.classical.build(a, near_null, nn_weights)
        raise ValueError(f"unknown interpolation kind {self.kind!r}")

    @property
    def coarse_block_size(self) -> int:
        """Coarse-level block size: candidate_dimension for SA, 1 for
        classical (reference hierarchy.rs:210-213)."""
        if self.kind == "aggregation":
            return self.aggregation.candidate_dimension
        return 1


__all__ = [
    "InterpolationConfig",
    "AggregationConfig",
    "ClassicalConfig",
    "GalerkinCoarse",
    "smoothed_aggregation",
    "smooth_interpolation",
    "block_jacobi_smooth",
]
