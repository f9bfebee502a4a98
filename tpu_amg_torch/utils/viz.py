"""Visualization export + live streaming hooks.

The port of the JAX package's ``tpu_amg/utils/viz.py``.  The reference
streams partitions/smooth-vectors to an external Bevy viewer over HTTP
(sci-bevy-comm, examples/aggregation/main.rs:252-535) and dumps a
hierarchy JSON (`MeshViz`/`InterpViz`, examples/amg/main.rs:142-194,
384-387).  Here the equivalent is dependency-free: serializable
dataclasses dumped to JSON, plus an optional stdlib HTTP client that
POSTs the same payloads to any viewer listening on localhost (same wire
role as ``SciBeevyClient``).  Arrays, device tensors included, are
brought to host numpy before they go into JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor is copied off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class PartitionMetrics:
    """Per-improvement-pass partitioner metrics
    (reference PartitionMetrics, aggregation example)."""

    iteration: int
    size_cost: float
    edge_cost: float
    modularity: float

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class MeshViz:
    """Hierarchy visualization dump (reference MeshViz/InterpViz,
    examples/amg/main.rs:142-194)."""

    coords: Optional[np.ndarray]
    levels: List[dict]

    def to_json(self) -> str:
        payload = {
            "coords": None if self.coords is None
            else _host(self.coords).tolist(),
            "levels": self.levels,
        }
        return json.dumps(payload)


def hierarchy_viz(hierarchy, coords=None) -> MeshViz:
    """Serialize per-level partitions + near-null vectors."""
    levels = []
    for lvl in range(hierarchy.num_levels - 1):
        part = hierarchy.partitions[lvl]
        nn = _host(hierarchy.get_near_null(lvl))
        levels.append(
            {
                "level": lvl,
                "kind": hierarchy.partition_kinds[lvl],
                "node_to_agg": _host(part.node_to_agg).tolist(),
                "num_aggs": int(part.num_aggs),
                "near_null_first": nn[:, 0].tolist(),
                "dims": [int(hierarchy.get_op(lvl).nrows)],
            }
        )
    return MeshViz(coords=coords, levels=levels)


def dump_hierarchy_viz(hierarchy, path, coords=None) -> None:
    """reference examples/amg/main.rs:384-387 (data/hierarchy_viz.json)."""
    from pathlib import Path

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(hierarchy_viz(hierarchy, coords).to_json())


class VizClient:
    """Minimal HTTP streaming client (role of SciBeevyClient:
    connect_local / health_check / update_partition / update_function).
    A viewer is optional: with nothing listening every call returns
    False."""

    def __init__(self, base_url: str = "http://127.0.0.1:8745"):
        self.base_url = base_url.rstrip("/")

    def _post(self, route: str, payload: dict) -> bool:
        import urllib.request

        try:
            req = urllib.request.Request(
                f"{self.base_url}{route}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=1.0) as resp:
                return 200 <= resp.status < 300
        except Exception:
            return False

    def health_check(self) -> bool:
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"{self.base_url}/health", timeout=1.0
            ) as resp:
                return 200 <= resp.status < 300
        except Exception:
            return False

    def upload_mesh(self, coords, cells=None) -> bool:
        return self._post(
            "/mesh",
            {
                "coords": _host(coords).tolist(),
                "cells": None if cells is None else _host(cells).tolist(),
            },
        )

    def upload_system_mesh(self, system) -> bool:
        """Upload an MfemLinearSystem's geometry: the loaded ``.vtk``
        triangle mesh when present (reference utils.rs:332-336 feeds
        MeshGeometry to the sci-bevy-comm client), the dof point cloud
        otherwise."""
        geo = getattr(system, "mesh_geometry", None)
        if geo is not None:
            return self.upload_mesh(geo.points, geo.cells)
        return self.upload_mesh(system.coords)

    def update_partition(self, node_to_agg) -> bool:
        return self._post(
            "/partition", {"node_to_agg": _host(node_to_agg).tolist()}
        )

    def update_function(self, values) -> bool:
        return self._post("/function", {"values": _host(values).tolist()})

    def update_metrics(self, metrics: PartitionMetrics) -> bool:
        return self._post("/metrics", metrics.to_dict())
