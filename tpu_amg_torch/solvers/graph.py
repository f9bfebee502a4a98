"""One iteration of a solve loop, captured in a CUDA graph and replayed.

The counterpart of the JAX package's jitted, operator-specialised solve
(``tpu_amg.solver.AMGSolver.compile``): PyTorch runs eagerly, so each
V-cycle enqueues its ~100 small launches from Python, and the device
idles while the host enqueues.  :class:`GraphStep` captures one
iteration of a solve (:func:`tpu_amg_torch.solvers.cg.cg_step` or
:func:`tpu_amg_torch.solvers.stationary.stationary_step`) once, on
static buffers, and replays it once an iteration in the same loop as the
eager solve (:func:`tpu_amg_torch.solvers.cg.iterate`), which reads ‖r‖
after each replay: the iterations, the history and x are those of the
eager solve, bit for bit.

Every result of the captured step is copied into the buffer of the state
it replaces, so that the next replay reads it.  The step runs on a side
stream before capture (warm-up), so that lazily made handles and
workspaces exist before the graph is captured.  A failed capture raises.

The kernel wrappers (:mod:`tpu_amg_torch.ops.spmv`, :mod:`tpu_amg_torch.ops.dia`)
count their launches when the graph is captured, though capture launches
nothing: those counts are taken back out, and each replay, which
launches the same kernels without passing through the wrappers, adds
them.  The warm-up step launches its kernels and counts them.
"""

from __future__ import annotations

import collections

import torch

from tpu_amg_torch import shard_utils
from tpu_amg_torch.ops import dia, spmv

WARMUP_STEPS = 1
# the solve path's launch counts: (module, name) of each total, of
# each Counter by (rows, cols, k) and of K1's by design
COUNTS = ((spmv, "csr_spmv_launches"), (spmv, "coo_patch_launches"),
          (dia, "dia_spmv_launches"), (spmv, "csr_spmv_launches_by_shape"),
          (spmv, "coo_patch_launches_by_shape"),
          (dia, "dia_spmv_launches_by_shape"),
          (spmv, "csr_spmv_launches_by_design"))


def launch_counts() -> dict:
    """A snapshot of the solve path's launch counts, by name."""
    snap = {}
    for module, name in COUNTS:
        value = getattr(module, name)
        snap[name] = (collections.Counter(value)
                      if isinstance(value, collections.Counter) else value)
    return snap


def counts_between(before: dict, after: dict) -> dict:
    """The launches counted from snapshot ``before`` to ``after``."""
    return {name: after[name] - before[name] for name in after}


def count_replays(captured: dict, replays: int) -> None:
    """Add ``replays`` × the ``captured`` launches to the counts
    (``replays`` < 0 takes them back out)."""
    for module, name in COUNTS:
        value = getattr(module, name)
        if isinstance(value, collections.Counter):
            value.update({key: replays * n
                          for key, n in captured[name].items()})
            for key in [key for key, n in value.items() if n == 0]:
                del value[key]
        else:
            setattr(module, name, value + replays * captured[name])


class GraphStep:
    """``step`` (state -> (state, ‖r‖ as a 0-d tensor)) captured in a
    CUDA graph on static copies of ``state``.  Calling it replays the
    graph and returns (the static state, the static ‖r‖), the contract
    :func:`tpu_amg_torch.solvers.cg.iterate` takes of a step."""

    def __init__(self, step, state):
        if shard_utils.active_group() is not None:
            # a sharded step's collectives and host reads (gloo) would be
            # captured as they are, or not at all: a sharded solve runs
            # eager
            raise RuntimeError("no CUDA graph of a sharded solve: a solver "
                               "group is active (parallel.dist.set_group)")
        self.state = tuple(t.clone() for t in state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step(self.state)
        torch.cuda.current_stream().wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new, self.res = step(self.state)
            for buf, value in zip(self.state, new):
                if value is not buf:
                    buf.copy_(value)
        # the launches of one replay; capture itself ran none of them
        self.captured = counts_between(before, launch_counts())
        count_replays(self.captured, -1)

    def load(self, state) -> None:
        """Copy a solve's first state into the static buffers."""
        for buf, value in zip(self.state, state):
            buf.copy_(value)

    def __call__(self, _state):
        self.graph.replay()
        count_replays(self.captured, 1)
        return self.state, self.res
