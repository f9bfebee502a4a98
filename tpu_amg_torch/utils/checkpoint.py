"""Read hierarchy checkpoints written by the JAX package.

``tpu_amg.utils.checkpoint.save_hierarchy`` (and ``AMGSolver.save``)
writes one ``.npz``: per level ``A{l}``, ``P{l}``, ``R{l}`` as CSR
triplets (``_data``, ``_indices``, ``_indptr``, ``_meta`` = rows, cols,
block size), the near-null basis ``nn{l}``, its weights ``w{l}``, the
partition ``part{l}`` (node → aggregate), and a JSON ``__meta__``.  The
format is host numpy only, so it loads here unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpu_amg_torch.hierarchy import Hierarchy, HierarchyConfig
from tpu_amg_torch.partition.partition import Partition
from tpu_amg_torch.sparse.csr import CSR


def _unpack_csr(prefix: str, arrays) -> CSR:
    meta = arrays[f"{prefix}_meta"]
    return CSR(
        data=np.asarray(arrays[f"{prefix}_data"]),
        indices=np.asarray(arrays[f"{prefix}_indices"]),
        indptr=np.asarray(arrays[f"{prefix}_indptr"]),
        shape=(int(meta[0]), int(meta[1])),
        block_size=int(meta[2]),
    )


def hierarchy_from_arrays(arrays, meta: dict) -> Hierarchy:
    """Build a :class:`Hierarchy` from the arrays and metadata that
    ``tpu_amg/utils/checkpoint.py`` packs (``_pack_hierarchy``)."""
    h = Hierarchy(
        config=HierarchyConfig(
            coarsest_dim=meta["coarsest_dim"], max_levels=meta["max_levels"]
        )
    )
    num_levels = meta["num_levels"]
    for lvl in range(num_levels):
        h.matrices.append(_unpack_csr(f"A{lvl}", arrays))
        h.near_nulls.append(np.asarray(arrays[f"nn{lvl}"]))
        h.nn_weights.append(np.asarray(arrays[f"w{lvl}"]))
    for lvl in range(num_levels - 1):
        h.interpolations.append(_unpack_csr(f"P{lvl}", arrays))
        h.restrictions.append(_unpack_csr(f"R{lvl}", arrays))
        h.partitions.append(Partition(arrays[f"part{lvl}"]))
    h.partition_kinds = list(meta["partition_kinds"])
    return h


def load_hierarchy(path) -> Hierarchy:
    """Read a single-hierarchy ``.npz`` checkpoint."""
    with np.load(Path(path)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if "components" in meta:
            raise ValueError(
                "this is an adaptive-composite checkpoint, which this "
                "package does not load yet"
            )
        return hierarchy_from_arrays(z, meta)
