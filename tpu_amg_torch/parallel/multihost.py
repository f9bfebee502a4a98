"""Multi-process distribution scaffolding over ``torch.distributed``.

Port of ``tpu_amg/parallel/multihost.py``.  The JAX package runs one
process per host, each driving its local devices; here every shard is a
process of its own (a rank), so a host runs as many ranks as it has
shards:

- :func:`initialize` wraps ``torch.distributed.init_process_group``,
  reading torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``) or explicit arguments; one process with
  nothing set is a no-op, as in the JAX package;
- :func:`pod_mesh` is a (nodes, ranks per node) grid of ranks whose row
  order keeps neighbours on one node, so the halo ring
  (:mod:`tpu_amg_torch.parallel.halo`) crosses nodes once a node
  boundary;
- :func:`global_put` is this rank's rows of a host array, on this rank's
  device;
- :func:`launch` starts one process a rank on this host with torchrun's
  environment, forked from one launcher that imported the rank's module
  once (what the tests, ``tools.bench_scaling`` and ``chip_smoke.py``
  use in place of torchrun).

Launch recipe (N ranks on one host)::

    torchrun --nproc-per-node N -m tpu_amg_torch.tools.dryrun_multichip \\
        --backend gloo --device cpu

NCCL takes one rank per GPU: a multi-rank NCCL run needs as many cards.
Several ranks on one card run gloo, their compute on that card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import runpy
import signal
import socket
import subprocess
import sys
import tempfile
import traceback
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_amg_torch.device import to_device
from tpu_amg_torch.shard_utils import SolverGroup

REPO_ROOT = Path(__file__).resolve().parents[2]
BACKENDS = ("nccl", "gloo")


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group (a no-op for one process with nothing set).

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``).
    ``backend`` is ``"nccl"`` for CUDA tensors, one rank a GPU (its card:
    ``LOCAL_RANK``), or ``"gloo"``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return  # single process
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """``grid[node, i]``: the global rank that holds row block
    ``node * ranks_per_node + i``; ``group`` shards rows in that order."""

    grid: np.ndarray
    group: SolverGroup


def pod_mesh(node_key=None) -> PodMesh:
    """The (nodes, ranks per node) grid of every rank, and a solver group
    whose row blocks follow it: nodes in the order of their lowest rank,
    a node's ranks in rank order, so that consecutive row blocks share a
    node.  ``node_key`` names this rank's node (default: the host name);
    a collective over the whole world.  Raises ``ValueError`` when nodes
    hold different numbers of ranks."""
    key = socket.gethostname() if node_key is None else node_key
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    nodes = {}
    for r, k in enumerate(keys):
        nodes.setdefault(k, []).append(r)
    counts = {len(v) for v in nodes.values()}
    if len(counts) != 1:
        raise ValueError(f"nodes hold {sorted(counts)} ranks: not a grid")
    grid = np.array(list(nodes.values()), dtype=np.int64)
    order = [int(r) for r in grid.ravel()]
    group = dist.new_group(order, sort_ranks=False)
    me = dist.get_rank()
    return PodMesh(grid=grid, group=SolverGroup(
        group=group, size=len(order), index=order.index(me),
        backend=dist.get_backend(group)))


def global_put(arr, group: SolverGroup, device, dtype=None) -> torch.Tensor:
    """This rank's rows of ``arr`` (a host array or tensor whose row count
    ``group.size`` divides), on ``device``."""
    if arr.shape[0] % group.size:
        raise ValueError(f"{arr.shape[0]} rows over {group.size} ranks")
    return to_device(arr[group.rows(arr.shape[0])], device, dtype)


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(module: str, argv: Sequence[str], world: int,
           timeout: float, env: Optional[dict] = None) -> list:
    """Run ``python -m module *argv`` as ``world`` ranks on this host, with
    torchrun's environment (a fresh ``MASTER_PORT``, ``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``) and one thread
    a rank (``OMP_NUM_THREADS=1``); returns each rank's standard output
    and error, in rank order.  One launcher process imports ``module``
    once and forks the ranks from it (:func:`_fork_ranks`): a rank costs
    no second import of torch.  Raises ``RuntimeError`` when a rank
    fails or the ranks outlast ``timeout`` seconds (every rank is then
    killed)."""
    base = dict(os.environ, **(env or {}))
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                OMP_NUM_THREADS="1")
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in [base.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        with open(Path(tmp) / "launcher.log", "w+") as log:
            proc = subprocess.Popen(
                [sys.executable, "-c", _LAUNCHER, tmp, module, str(world),
                 *argv], cwd=REPO_ROOT, env=base, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                pass
            finally:
                # the launcher and its ranks: one process group
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.seek(0)
            launcher = log.read()
        outs = []
        for r in range(world):
            path = Path(tmp) / f"rank{r}.log"
            outs.append(path.read_text() if path.exists() else "")
        codes_file = Path(tmp) / "codes.json"
        codes = (json.loads(codes_file.read_text()) if codes_file.exists()
                 else None)
    if codes is None or proc.returncode != 0:
        bad = ([r for r, c in enumerate(codes) if c != 0] if codes
               else list(range(world)))
        # the first rank that failed of itself, not one killed after it
        r = min(bad, key=lambda i: (codes is None or codes[i] < 0, i),
                default=0)
        why = ("timed out" if codes is None and proc.returncode < 0
               else f"exit {codes[r] if codes else proc.returncode}")
        raise RuntimeError(
            f"{module}: rank(s) {bad} of {world} failed (rank {r}: {why}):"
            f"\n{outs[r][-4000:]}\n{launcher[-2000:]}")
    return outs


_LAUNCHER = ("import sys; from tpu_amg_torch.parallel.multihost import "
             "_fork_ranks; sys.exit(_fork_ranks(sys.argv[1], sys.argv[2], "
             "int(sys.argv[3]), sys.argv[4:]))")


def _fork_ranks(directory: str, module: str, world: int,
                argv: Sequence[str]) -> int:
    """The launcher of :func:`launch`: import ``module`` here once (its
    work must sit under ``if __name__ == "__main__"``), fork ``world``
    ranks that each run it as ``__main__`` with their own
    ``RANK`` and ``LOCAL_RANK``, their output in ``<directory>/rank<r>.log``;
    at the first rank that fails, kill the others.  Writes every rank's
    exit code to ``<directory>/codes.json``; returns 0 when all are 0.
    Nothing here starts a thread or touches a device before the fork
    (importing the port starts none)."""
    importlib.import_module(module)
    sys.stdout.flush()
    sys.stderr.flush()
    ranks = {}
    for r in range(world):
        pid = os.fork()
        if pid == 0:  # the rank
            code = 1
            try:
                fd = os.open(Path(directory) / f"rank{r}.log",
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                os.environ.update(RANK=str(r), LOCAL_RANK=str(r))
                sys.argv = [module, *argv]
                warnings.filterwarnings("ignore", category=RuntimeWarning,
                                        module="runpy")
                runpy.run_module(module, run_name="__main__", alter_sys=True)
                code = 0
            except SystemExit as exc:  # as the interpreter takes it
                if exc.code is None or isinstance(exc.code, int):
                    code = exc.code or 0
                else:
                    print(exc.code, file=sys.stderr)
            except BaseException:  # reported; the rank exits below
                traceback.print_exc()
            finally:  # a forked rank never returns into the launcher
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        ranks[pid] = r
    codes = [None] * world
    while ranks:
        pid, status = os.wait()
        r = ranks.pop(pid)
        codes[r] = os.waitstatus_to_exitcode(status)
        if codes[r] != 0:  # the others would block in a collective
            for other in ranks:
                os.kill(other, signal.SIGKILL)
    (Path(directory) / "codes.json").write_text(json.dumps(codes))
    return int(any(codes))
