"""Interpolation (coarsening): smoothed aggregation (reference
src/interpolation/).

``InterpolationConfig`` is the dispatch point of the reference
(interpolation/mod.rs:28-60).  This package implements the aggregation
family; classical CR+LS interpolation is not ported yet, and asking for
it raises.
"""

from __future__ import annotations

import dataclasses

from tpu_amg_torch.interpolation.sa import (
    AggregationConfig,
    GalerkinCoarse,
    block_jacobi_smooth,
    smooth_interpolation,
    smoothed_aggregation,
)


@dataclasses.dataclass
class InterpolationConfig:
    """Dispatch enum analog (interpolation/mod.rs:28-60); ``kind`` must
    be "aggregation"."""

    kind: str = "aggregation"
    aggregation: AggregationConfig = dataclasses.field(
        default_factory=AggregationConfig
    )

    def build(self, a, near_null, nn_weights) -> GalerkinCoarse:
        if self.kind == "aggregation":
            return self.aggregation.build(a, near_null, nn_weights)
        raise NotImplementedError(f"interpolation kind {self.kind!r}")


__all__ = [
    "InterpolationConfig",
    "AggregationConfig",
    "GalerkinCoarse",
    "smoothed_aggregation",
    "smooth_interpolation",
    "block_jacobi_smooth",
]
