"""Hierarchy checkpoint / resume, in the JAX package's format.

One ``.npz`` (``tpu_amg/utils/checkpoint.py``): per level ``A{l}``,
``P{l}``, ``R{l}`` as CSR triplets (``_data``, ``_indices``,
``_indptr``, ``_meta`` = rows, cols, block size), the near-null basis
``nn{l}``, its weights ``w{l}``, the partition ``part{l}`` (node →
aggregate), and a JSON ``__meta__``.  The adaptive composite's archive
(``save_composite_hierarchies``) holds each component's hierarchy under
the prefix ``c{k}_`` and lists their metadata under ``components``.
Everything is host numpy, so an archive written by either package loads
in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpu_amg_torch.hierarchy import Hierarchy, HierarchyConfig
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.sparse.csr import CSR


def _pack_csr(prefix: str, m: CSR, out: dict):
    out[f"{prefix}_data"] = m.data
    out[f"{prefix}_indices"] = m.indices
    out[f"{prefix}_indptr"] = m.indptr
    out[f"{prefix}_meta"] = np.array(
        [m.shape[0], m.shape[1], m.block_size], dtype=np.int64
    )


def _unpack_csr(prefix: str, arrays) -> CSR:
    meta = arrays[f"{prefix}_meta"]
    return CSR(
        data=np.asarray(arrays[f"{prefix}_data"]),
        indices=np.asarray(arrays[f"{prefix}_indices"]),
        indptr=np.asarray(arrays[f"{prefix}_indptr"]),
        shape=(int(meta[0]), int(meta[1])),
        block_size=int(meta[2]),
    )


def _pack_hierarchy(h: Hierarchy, arrays: dict, prefix: str = "") -> dict:
    meta = {
        "num_levels": h.num_levels,
        "partition_kinds": h.partition_kinds,
        "coarsest_dim": h.config.coarsest_dim,
        "max_levels": h.config.max_levels,
    }
    for lvl in range(h.num_levels):
        _pack_csr(f"{prefix}A{lvl}", h.matrices[lvl], arrays)
        arrays[f"{prefix}nn{lvl}"] = h.near_nulls[lvl]
        arrays[f"{prefix}w{lvl}"] = h.nn_weights[lvl]
    for lvl in range(h.num_levels - 1):
        _pack_csr(f"{prefix}P{lvl}", h.interpolations[lvl], arrays)
        _pack_csr(f"{prefix}R{lvl}", h.restrictions[lvl], arrays)
        arrays[f"{prefix}part{lvl}"] = h.partitions[lvl].node_to_agg
    return meta


def hierarchy_from_arrays(arrays, meta: dict, prefix: str = "") -> Hierarchy:
    """Build a :class:`Hierarchy` from the arrays and metadata that
    ``save_hierarchy`` packs (``prefix`` ``c{k}_``: component k of a
    composite archive)."""
    h = Hierarchy(
        config=HierarchyConfig(
            coarsest_dim=meta["coarsest_dim"], max_levels=meta["max_levels"]
        )
    )
    num_levels = meta["num_levels"]
    for lvl in range(num_levels):
        h.matrices.append(_unpack_csr(f"{prefix}A{lvl}", arrays))
        h.near_nulls.append(np.asarray(arrays[f"{prefix}nn{lvl}"]))
        h.nn_weights.append(np.asarray(arrays[f"{prefix}w{lvl}"]))
    for lvl in range(num_levels - 1):
        h.interpolations.append(_unpack_csr(f"{prefix}P{lvl}", arrays))
        h.restrictions.append(_unpack_csr(f"{prefix}R{lvl}", arrays))
        h.partitions.append(Partition(arrays[f"{prefix}part{lvl}"]))
    h.partition_kinds = list(meta["partition_kinds"])
    return h


def _write(path, arrays: dict, meta: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def read_meta(z) -> dict:
    """The JSON metadata of an open archive."""
    return json.loads(bytes(z["__meta__"]).decode())


def save_hierarchy(path, h: Hierarchy) -> None:
    """Write ``h`` to one compressed ``.npz`` at ``path``."""
    arrays: dict = {}
    meta = _pack_hierarchy(h, arrays)
    meta["version"] = 1
    _write(path, arrays, meta)


def load_hierarchy(path) -> Hierarchy:
    """Read a single-hierarchy ``.npz`` checkpoint."""
    with np.load(Path(path)) as z:
        meta = read_meta(z)
        if "components" in meta:
            raise ValueError(
                "this is a composite checkpoint; use "
                "load_composite_hierarchies"
            )
        return hierarchy_from_arrays(z, meta)


def save_composite_hierarchies(path, hierarchies) -> None:
    """Checkpoint an adaptive composite: the per-component hierarchies
    (the expensive bootstrap artifact — reference adaptivity.rs:50-165
    rebuilds it from scratch every run)."""
    arrays: dict = {}
    metas = [
        _pack_hierarchy(h, arrays, prefix=f"c{k}_")
        for k, h in enumerate(hierarchies)
    ]
    _write(path, arrays, {"version": 1, "components": metas})


def load_composite_hierarchies(path):
    """Read a composite ``.npz`` checkpoint: its hierarchies, in
    component order."""
    with np.load(Path(path)) as z:
        meta = read_meta(z)
        if "components" not in meta:
            raise ValueError(
                "this is a single-hierarchy checkpoint; use load_hierarchy"
            )
        return [
            hierarchy_from_arrays(z, m, prefix=f"c{k}_")
            for k, m in enumerate(meta["components"])
        ]
