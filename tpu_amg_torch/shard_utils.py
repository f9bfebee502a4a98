"""Sharding-aware primitives over ``torch.distributed``.

Port of ``tpu_amg/shard_utils.py``.  The JAX package is single-controller
SPMD: arrays carry ``NamedSharding``s and XLA inserts the psums and
all-gathers.  Here a shard is a rank, one process holding its own rows
as plain local tensors, so every collective XLA added implicitly is
written out at a named place:

- the dot products' ``all_reduce`` (:func:`sdot`, :func:`snorm`);
- the ``all_gather`` at the shard/replicate boundary
  (:func:`ensure_replicated`);
- the halo slabs' point-to-point exchange
  (:func:`tpu_amg_torch.parallel.halo.ring_exchange`).

The solver group these reduce over is the *active* one, set by
:func:`tpu_amg_torch.parallel.dist.set_group` (the counterpart of
``jax.set_mesh``), not passed through every call.  With no active group
:func:`sdot` and :func:`snorm` are exactly ``torch.sum(a * b)`` and its
square root, as before the port had a distributed path.

**Gloo and CUDA tensors.**  Gloo's point-to-point calls take CPU tensors
only, so where a group's backend is gloo and a tensor lies on the card
every collective here copies it to the host and back
(:func:`host_staged`).  The choice is made from the backend, never as a
reaction to a failure.  NCCL takes one rank per GPU, so a multi-rank run
on one card uses gloo with its compute on ``cuda:0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SolverGroup:
    """The ranks that hold one row-sharded solve, in row-block order:
    group rank i owns row block i of every sharded level.  ``group`` is
    the ``torch.distributed`` process group; ``index`` is this process's
    row block, -1 where it is not a member."""

    group: Any
    size: int
    index: int
    backend: str

    @property
    def member(self) -> bool:
        return self.index >= 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row sharded array."""
        n_loc = n // self.size
        return slice(self.index * n_loc, (self.index + 1) * n_loc)


_active: Optional[SolverGroup] = None


def active_group() -> Optional[SolverGroup]:
    """The group set by :func:`tpu_amg_torch.parallel.dist.set_group`,
    or None."""
    return _active


def host_staged(group: SolverGroup, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of ``group`` sends or fills in place of
    ``t``: a host copy where the backend is gloo and ``t`` lies on the
    card (gloo's point-to-point calls take CPU tensors only), else ``t``
    itself.  Results are copied back with :func:`unstage`."""
    if group.backend == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t


def unstage(staged: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return staged if staged.device == like.device else staged.to(like.device)


def all_reduce_sum(t: torch.Tensor, group: SolverGroup) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor)."""
    buf = host_staged(group, t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.group)
    return unstage(buf, t)


def all_gather_rows(x: torch.Tensor, group: SolverGroup) -> torch.Tensor:
    """The whole row-sharded array: every rank's rows of ``x``, in
    row-block order (group rank order)."""
    if group.size == 1:
        return x
    buf = host_staged(group, x.contiguous())
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.group)
    return unstage(torch.cat(parts), x)


def sdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real inner product of two row-sharded vectors (a 0-d tensor on
    their device): the local partial sum, all-reduced over the active
    group; ``torch.sum(a * b)`` when none is active."""
    s = torch.sum(a * b)
    return s if _active is None else all_reduce_sum(s, _active)


def snorm(a: torch.Tensor) -> torch.Tensor:
    """2-norm via :func:`sdot`."""
    return torch.sqrt(sdot(a, a))


def ensure_replicated(x: torch.Tensor,
                      group: Optional[SolverGroup] = None) -> torch.Tensor:
    """The whole vector from this rank's rows of it: the coarse-level
    all-gather of a sharded V-cycle (``group``: the active one when
    None; no group, or one of one rank, returns ``x``)."""
    group = group or _active
    return x if group is None else all_gather_rows(x, group)
