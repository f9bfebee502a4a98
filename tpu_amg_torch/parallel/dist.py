"""Row-partitioned sharding of operators and multigrid hierarchies.

Port of ``tpu_amg/parallel/dist.py``.  The JAX package shards arrays
over a device mesh and lets XLA insert the collectives.  Here a shard is
a rank (one process) holding its own rows as local tensors, and each
collective is written where it happens:

- a sharded level's operator is a halo form
  (:mod:`tpu_amg_torch.parallel.halo`: two point-to-point slabs an
  apply) or, where the band does not hold, the all-gather form
  (:func:`shard_csr`, :func:`shard_ell`: the vector all-gathered, this
  rank's rows applied); a level over a ``BSR`` is replicated, as the
  JAX package replicates it;
- the dot products all-reduce over the active group
  (:func:`set_group`, the counterpart of ``jax.set_mesh``;
  :mod:`tpu_amg_torch.shard_utils`);
- a replicated level (below ``replicate_below`` rows, or not divisible
  by the group) holds the whole vector on every rank: the restriction
  above it all-gathers its output, the prolongation above it applies
  this rank's rows to the whole coarse vector (:class:`Boundary`,
  :class:`RowBlockCSR`), and the coarse solve runs replicated on the
  same gathered input on every rank;
- the block smoother's aggregates are sharded by batch: the whole input
  all-gathered, this rank's aggregates solved, the scattered updates
  all-reduced and this rank's rows kept (:class:`ShardedBlockSmoother`);
  aggregates do not overlap, so the sum adds only zeros.

Every rank holds the same host setup (hierarchy, partitions); sharding
keeps this rank's rows of it on its device.  A sharded solve runs eager:
a CUDA graph capture raises while a group is active
(``solvers/graph.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from tpu_amg_torch import shard_utils
from tpu_amg_torch.linop import (DiagonalOperator, LinearOperator,
                                 SparseOperator, _apply)
from tpu_amg_torch.ops import dia, spmv
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.parallel.halo import HaloCSR, HaloDIA, HaloELL
from tpu_amg_torch.parallel.multihost import global_put
from tpu_amg_torch.preconditioners.block_smoother import (BlockBucket,
                                                          BlockSmoother)
from tpu_amg_torch.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg_torch.preconditioners.multigrid import Level, Multigrid
from tpu_amg_torch.shard_utils import SolverGroup, all_gather_rows, all_reduce_sum
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.sparse.ell import ELL


def make_solver_mesh(n_ranks: Optional[int] = None) -> SolverGroup:
    """A solver group over the first ``n_ranks`` ranks (all when None), in
    rank order; a collective over the whole world.  Ranks past
    ``n_ranks`` get a group they are no member of (``index`` -1)."""
    world = dist.get_world_size()
    n = world if n_ranks is None else n_ranks
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks of a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return SolverGroup(group=group, size=n, index=rank if rank < n else -1,
                       backend=dist.get_backend(dist.group.WORLD))


@contextlib.contextmanager
def set_group(group: Optional[SolverGroup]):
    """Make ``group`` the active solver group inside the block: the one
    that :func:`~tpu_amg_torch.shard_utils.sdot` and ``snorm`` reduce
    over (the counterpart of ``jax.set_mesh``)."""
    saved = shard_utils._active
    shard_utils._active = group
    try:
        yield group
    finally:
        shard_utils._active = saved


def pad_csr_identity(csr: CSR, multiple: int) -> CSR:
    """Extend a square CSR with identity rows so that nrows % multiple ==
    0; solutions of the padded system restrict to the original."""
    n = csr.nrows
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return csr
    extra = np.arange(n, n_pad)
    return CSR(
        data=np.concatenate([csr.data, np.ones(n_pad - n)]),
        indices=np.concatenate([csr.indices, extra]).astype(np.int32),
        indptr=np.concatenate([csr.indptr,
                               csr.indptr[-1] + 1 + np.arange(n_pad - n)]),
        shape=(n_pad, n_pad),
    )


def pad_ell_identity(ell: ELL, multiple: int) -> ELL:
    """Extend a square ELL with identity rows (value 1 in slot 0, column
    n + i) so that nrows % multiple == 0, on the ELL's device; its
    capped CSR gains the same rows (:func:`pad_csr_identity`)."""
    n = ell.nrows
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return ell
    data = ell.data.new_zeros((n_pad, ell.k))
    data[:n] = ell.data
    data[n:, 0] = 1.0
    cols = ell.cols.new_zeros((n_pad, ell.k))
    cols[:n] = ell.cols
    cols[n:, 0] = torch.arange(n, n_pad, dtype=cols.dtype, device=cols.device)
    csr = pad_csr_identity(ell.capped.to_csr(), multiple)
    return ELL(data=data, cols=cols, shape=(n_pad, n_pad),
               nnz=ell.nnz + n_pad - n, block_size=1,
               capped=CappedCSR.from_csr(csr, ell.device, ell.dtype))


def row_block(csr: CSR, group: SolverGroup) -> CSR:
    """This rank's rows of ``csr`` (global columns)."""
    rows = group.rows(csr.nrows)
    lo, hi = csr.indptr[rows.start], csr.indptr[rows.stop]
    return CSR(data=csr.data[lo:hi], indices=csr.indices[lo:hi],
               indptr=csr.indptr[rows.start:rows.stop + 1] - lo,
               shape=(rows.stop - rows.start, csr.ncols))


def ell_row_block(ell: ELL, group: SolverGroup, device) -> ELL:
    """This rank's rows of ``ell`` (global columns) on ``device``."""
    rows = group.rows(ell.nrows)
    capped = CappedCSR.from_csr(row_block(ell.capped.to_csr(), group),
                                device, ell.dtype)
    return ELL(data=ell.data[rows].to(device).contiguous(),
               cols=ell.cols[rows].to(device).contiguous(),
               shape=(rows.stop - rows.start, ell.ncols), nnz=capped.nnz,
               block_size=ell.block_size, capped=capped)


@dataclasses.dataclass
class RowBlockCSR(LinearOperator):
    """This rank's rows of a CSR (a ``CappedCSR``, or an ``ELL``)
    applied, with K1 + K2, to the whole (replicated) input vector:
    returns this rank's rows of y."""

    local: Union[CappedCSR, ELL]
    shape: tuple

    def mv(self, x):
        return _apply(self.local, x)

    def mm(self, xs):
        return _apply(self.local, xs)


@dataclasses.dataclass
class Boundary(LinearOperator):
    """``inner`` between layouts: the input all-gathered first
    (``gather_in``), and the output all-gathered (``gather_out``) or cut
    to this rank's rows (``slice_out``) after: the one place where a
    vector crosses the shard/replicate boundary."""

    inner: LinearOperator
    group: SolverGroup
    gather_in: bool = False
    gather_out: bool = False
    slice_out: bool = False

    @property
    def shape(self):
        return self.inner.shape

    def _run(self, x):
        if self.gather_in:
            x = all_gather_rows(x, self.group)
        y = self.inner(x)
        if self.gather_out:
            y = all_gather_rows(y, self.group)
        if self.slice_out:
            y = y[self.group.rows(y.shape[0])]
        return y

    def mv(self, x):
        return self._run(x)

    def mm(self, xs):
        return self._run(xs)


def shard_csr(csr: CSR, group: SolverGroup, device,
              dtype=torch.float64) -> Boundary:
    """The all-gather form of a row-sharded CSR (the port of
    ``shard_ell``): the input all-gathered, this rank's rows applied."""
    if csr.nrows % group.size or csr.ncols % group.size:
        raise ValueError(f"shape {csr.shape} not divisible by {group.size} "
                         "ranks; use pad_csr_identity first")
    local = CappedCSR.from_csr(row_block(csr, group), device, dtype)
    return Boundary(RowBlockCSR(local, tuple(csr.shape)), group,
                    gather_in=True)


def shard_ell(ell: ELL, group: SolverGroup, device) -> Boundary:
    """The all-gather form of a row-sharded ELL (the port of
    ``shard_ell``): the input all-gathered, this rank's rows (an ELL on
    ``device``) applied.  Raises ``TypeError`` for anything but an ELL
    and ``ValueError`` where the group does not divide the rows (use
    :func:`pad_ell_identity` first)."""
    if not isinstance(ell, ELL):
        raise TypeError(f"shard_ell requires an ELL, got {type(ell).__name__}"
                        " (build it with ELL.from_csr)")
    if ell.nrows % group.size or ell.ncols % group.size:
        raise ValueError(f"shape {ell.shape} not divisible by {group.size} "
                         "ranks; use pad_ell_identity first")
    return Boundary(RowBlockCSR(ell_row_block(ell, group, device),
                                tuple(ell.shape)), group, gather_in=True)


def replicate(obj, group: SolverGroup, src: int = 0):
    """Row block ``src``'s ``obj`` on every rank of ``group`` (a broadcast
    of the pickled object; tensors travel through the host).  Every rank
    holds the whole of a replicated level already: this shares a setup
    that one rank computed.  One rank: ``obj`` itself."""
    if group.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, group=group.group, group_src=src)
    return box[0]


def try_shard_halo(mat, group: SolverGroup):
    """The halo form of a device matrix (``DIA`` → :class:`HaloDIA`,
    ``ELL`` → :class:`HaloELL`, ``CappedCSR`` → :class:`HaloCSR`), or
    None when the band (or divisibility) fails, or for a ``BSR``:
    callers fall back to the all-gather path or replicate."""
    try:
        if isinstance(mat, DIA):
            return HaloDIA.from_dia(mat, group)
        if isinstance(mat, ELL):
            return HaloELL.from_ell(mat, group)
        if isinstance(mat, CappedCSR):
            return HaloCSR.from_csr(mat.to_csr(), group, mat.device,
                                    mat.dtype)
    except ValueError:
        return None
    return None


def try_shard_halo_op(op: SparseOperator, group: SolverGroup):
    """The halo form of a square ``SparseOperator``'s matrix, or None."""
    return try_shard_halo(op.mat, group)


@dataclasses.dataclass
class _WithTranspose(LinearOperator):
    fwd: LinearOperator
    bwd: LinearOperator

    @property
    def shape(self):
        return self.fwd.shape

    def mv(self, x):
        return self.fwd(x)

    def mm(self, xs):
        return self.fwd(xs)

    def rmv(self, x):
        return self.bwd(x)

    def rmm(self, xs):
        return self.bwd(xs)


def _shard_mat(mat, group: SolverGroup):
    """The halo form of a device matrix, else the all-gather form (CSR,
    ELL); a BSR, or a DIA matrix outside the band, raises
    ``ValueError``."""
    h = try_shard_halo(mat, group)
    if h is not None:
        return h
    if isinstance(mat, (DIA, BSR)):
        raise ValueError(f"a {type(mat).__name__} matrix has no sharded "
                         "form here (a DIA one outside the halo band)")
    if isinstance(mat, ELL):
        return shard_ell(mat, group, mat.device)
    return shard_csr(mat.to_csr(), group, mat.device, mat.dtype)


def shard_operator(op: SparseOperator, group: SolverGroup) -> LinearOperator:
    """Row-shard a square sparse operator (and its transpose if it has
    one): the halo form where the band holds, else the all-gather form."""
    fwd = _shard_mat(op.mat, group)
    if op.mat_t is None:
        return fwd
    return _WithTranspose(fwd, _shard_mat(op.mat_t, group))


def _shard_block_bucket(b: BlockBucket, group: SolverGroup) -> BlockBucket:
    """This rank's share of one bucket's aggregates: the batch padded to a
    multiple of the group with identity blocks on dof 0 under a zero
    mask (they add 0 there), then cut in equal slices."""
    n = group.size
    n_aggs = b.inv_blocks.shape[0]
    pad = -n_aggs % n
    if pad:
        s = b.inv_blocks.shape[1]
        eye = torch.eye(s, dtype=b.inv_blocks.dtype,
                        device=b.inv_blocks.device).expand(pad, s, s)
        b = BlockBucket(
            inv_blocks=torch.cat([b.inv_blocks, eye]),
            idx=torch.cat([b.idx, b.idx.new_zeros((pad, s))]),
            mask=torch.cat([b.mask, b.mask.new_zeros((pad, s))]),
        )
    share = group.rows(n_aggs + pad)
    return BlockBucket(inv_blocks=b.inv_blocks[share].contiguous(),
                       idx=b.idx[share].contiguous(),
                       mask=b.mask[share].contiguous())


@dataclasses.dataclass
class ShardedBlockSmoother(LinearOperator):
    """A block smoother whose aggregates are sharded by batch: the input
    all-gathered (an aggregate's ``idx`` reaches any row), this rank's
    aggregates solved into a whole-length update, the updates summed
    over the group (all-reduce) and this rank's rows kept."""

    local: BlockSmoother
    group: SolverGroup

    @property
    def shape(self):
        return self.local.shape

    def _run(self, x):
        out = self.local(all_gather_rows(x, self.group))
        if self.group.size > 1:
            out = all_reduce_sum(out, self.group)
        return out[self.group.rows(self.local.n)]

    def mv(self, x):
        return self._run(x)

    def mm(self, xs):
        return self._run(xs)


def _shard_block_smoother(bs: BlockSmoother,
                          group: SolverGroup) -> ShardedBlockSmoother:
    return ShardedBlockSmoother(
        BlockSmoother(buckets=tuple(_shard_block_bucket(b, group)
                                    for b in bs.buckets), n=bs.n), group)


def _shard_smoother(smoother, a_sharded, group: SolverGroup):
    """A sharded level's smoother on this rank's rows: per-row smoothers
    keep this rank's rows of their diagonal (Chebyshev: its λ bounds
    too, and the sharded A); others run replicated behind a
    :class:`Boundary`."""
    if isinstance(smoother, BlockSmoother):
        return _shard_block_smoother(smoother, group)
    if isinstance(smoother, ChebyshevSmoother):
        return dataclasses.replace(
            smoother, a=a_sharded,
            d_inv=smoother.d_inv[group.rows(smoother.d_inv.shape[0])])
    if isinstance(smoother, DiagonalOperator):
        return DiagonalOperator(
            smoother.diag[group.rows(smoother.diag.shape[0])])
    return Boundary(smoother, group, gather_in=True, slice_out=True)


def _as_ell_operator(op):
    """The operator itself.  The JAX package re-derives ELL here from its
    single-chip fast formats (``BandedDense``, and a
    ``TransposeOperator`` over one); the port has no ``BandedDense``,
    its sparse operators are CSR, DIA, ELL or BSR, which
    :func:`shard_csr_rect` shards as they are (a ``TransposeOperator``
    runs replicated)."""
    return op


def shard_csr_rect(op: LinearOperator, group: SolverGroup, in_sharded: bool,
                   out_sharded: bool) -> LinearOperator:
    """A transfer operator between a fine and a coarse level, each sharded
    or replicated (the port of ``shard_ell_rect``): the halo form when
    both sides are sharded and the band holds, else the all-gather form;
    a replicated output is all-gathered from the sharded rows where the
    rows divide; a replicated input is applied by this rank's rows
    (:class:`RowBlockCSR`, no communication).  Operators that are not
    CSR or ELL run replicated behind a :class:`Boundary`."""
    op = _as_ell_operator(op)
    if not in_sharded and not out_sharded:
        return op
    mat = getattr(op, "mat", None)
    if not isinstance(mat, (CappedCSR, ELL)):
        return Boundary(op, group, gather_in=in_sharded,
                        slice_out=out_sharded)
    if not in_sharded:
        local = (ell_row_block(mat, group, mat.device)
                 if isinstance(mat, ELL) else
                 CappedCSR.from_csr(row_block(mat.to_csr(), group),
                                    mat.device, mat.dtype))
        return RowBlockCSR(local, tuple(mat.shape))
    if mat.shape[0] % group.size:
        return Boundary(op, group, gather_in=True)
    sharded = _shard_mat(mat, group)
    return sharded if out_sharded else Boundary(sharded, group,
                                                gather_out=True)


def level_forms(mg) -> list:
    """Each level's operator form: ``HaloCSR``, ``HaloELL``,
    ``HaloDIA``, ``shard_csr``, ``shard_ell`` or ``replicated``."""
    if isinstance(mg, Boundary):  # a preconditioner replicated whole
        return ["replicated"] * len(getattr(mg.inner, "levels", (None,)))
    forms = []
    for level in mg.levels:
        a = level.a
        forms.append(
            type(a).__name__ if isinstance(a, (HaloCSR, HaloELL, HaloDIA))
            else ("shard_ell" if isinstance(
                getattr(a.inner, "local", None), ELL) else "shard_csr")
            if isinstance(a, Boundary)
            else "replicated")
    return forms


def shard_multigrid(mg: Multigrid, group: SolverGroup,
                    replicate_below: int = 4096) -> LinearOperator:
    """Shard fine levels over ``group``; replicate small coarse levels.

    A level is sharded when its operator is sparse, its dimension is at
    least ``replicate_below`` and the group divides it, and a sharded form
    exists (halo, or all-gather for CSR; a DIA level outside the band is
    replicated, as in the JAX package); everything below it and the
    coarse solver is replicated.  The cycle (``preconditioners/
    multigrid.py``) is unchanged: the transfers carry the boundary.
    Takes and returns this rank's rows; a multigrid whose fine level is
    replicated is wrapped so that it does too."""
    n = group.size
    sharded = []
    for level in mg.levels:
        a = None
        if (isinstance(level.a, SparseOperator)
                and level.a.shape[0] >= replicate_below
                and level.a.shape[0] % n == 0):
            try:
                a = _shard_mat(level.a.mat, group)
            except ValueError:
                a = None
        sharded.append(a)
    layout = [a is not None for a in sharded] + [False]
    levels = []
    for lvl, level in enumerate(mg.levels):
        fine, coarse = layout[lvl], layout[lvl + 1]
        a = sharded[lvl] if fine else level.a
        levels.append(Level(
            a=a,
            smoother=(_shard_smoother(level.smoother, a, group) if fine
                      else level.smoother),
            r=shard_csr_rect(level.r, group, fine, coarse),
            p=shard_csr_rect(level.p, group, coarse, fine),
        ))
    out = dataclasses.replace(mg, levels=tuple(levels))
    if not layout[0]:
        return Boundary(out, group, gather_in=True, slice_out=True)
    return out


def shard_vector(x, group: SolverGroup, device=None, dtype=None):
    """This rank's rows of a whole vector or (n, k) block."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    return global_put(x, group, device, dtype)


def _launches() -> dict:
    """K1's, K2's and K3's launches so far in this process, by (rows,
    cols, k)."""
    return {"K1": collections.Counter(spmv.csr_spmv_launches_by_shape),
            "K2": collections.Counter(spmv.coo_patch_launches_by_shape),
            "K3": collections.Counter(dia.dia_spmv_launches_by_shape)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ShardedSolve:
    """One PCG solved twice from the same operator, preconditioner and
    right-hand side: sharded over a group, and whole on this rank."""

    x: torch.Tensor  # the sharded solve's x, all-gathered
    info: object  # its SolveInfo
    x_one: torch.Tensor  # the unsharded solve's x
    info_one: object
    fine: LinearOperator  # the sharded fine operator
    pc: LinearOperator  # the sharded preconditioner
    seconds: float  # the sharded solve on this rank's clock
    seconds_one: float
    launches: dict  # this rank's K1 / K2 / K3 launches in the sharded solve

    @property
    def forms(self) -> list:
        """Each level's form (:func:`level_forms`)."""
        return level_forms(self.pc)

    @property
    def rel_err(self) -> float:
        scale = max(float(self.x_one.abs().max()), 1e-30)
        return float((self.x - self.x_one).abs().max()) / scale

    @property
    def bitwise(self) -> bool:
        return torch.equal(self.x, self.x_one)


def solve_sharded(op: SparseOperator, pc, b: torch.Tensor,
                  group: SolverGroup, *, rtol: float, maxiter: int = 1000,
                  replicate_below: int = 4096,
                  warmup: bool = False) -> ShardedSolve:
    """PCG of ``op`` x = ``b`` (``b`` whole, on every rank) sharded over
    ``group`` and on this rank alone.  A :class:`Multigrid` ``pc`` is
    sharded by :func:`shard_multigrid`; any other preconditioner runs
    replicated behind a :class:`Boundary`.  With ``warmup`` each solve
    runs once untimed first, so that neither time holds the first use
    of a collective (NCCL sets its communicator up there) or of an
    allocation.  The launches are read just before and just after the
    timed sharded solve."""
    fine = shard_operator(op, group)
    pc_sh = (shard_multigrid(pc, group, replicate_below)
             if isinstance(pc, Multigrid)
             else Boundary(pc, group, gather_in=True, slice_out=True))
    b_loc = shard_vector(b, group)
    device = b.device

    def timed(run):
        if warmup:
            run()
        _sync(device)
        before = _launches()
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        seconds = time.perf_counter() - t0
        after = _launches()
        return out, seconds, {k: after[k] - before[k] for k in after}

    (x_one, info_one), t_one, _ = timed(
        lambda: cg(op, b, pc, rtol=rtol, maxiter=maxiter))
    with set_group(group):
        (x, info), t, launches = timed(
            lambda: cg(fine, b_loc, pc_sh, rtol=rtol, maxiter=maxiter))
        x = all_gather_rows(x, group)
    return ShardedSolve(x=x, info=info, x_one=x_one, info_one=info_one,
                        fine=fine, pc=pc_sh, seconds=t, seconds_one=t_one,
                        launches=launches)
