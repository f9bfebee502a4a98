"""Halo-exchange SpMV over ranks: the distributed compute path.

Port of ``tpu_amg/parallel/halo.py``.  For banded orderings (structured
grids, RCM-ordered FEM meshes) each rank exchanges only a fixed-width
halo slab of its rows with its two neighbours in row order, then applies
a local operator to the [left halo | own rows | right halo] buffer: two
point-to-point transfers an apply in place of an all-gather of the
vector.

Three operator forms, each a :class:`~tpu_amg_torch.linop.LinearOperator`
taking and returning this rank's rows:

- :class:`HaloCSR`, the port's counterpart of ``HaloWELL`` and
  ``HaloHybrid`` (WELL and the hybrid split are TPU layouts of K1's
  contract, not device formats of the port): a local ``CappedCSR`` of
  (n_loc_rows × (n_loc_cols + 2·halo)) applied with K1 + K2, as
  ``_well_shard`` runs K1's TPU original per shard
  (``halo.py:619-630``).  It covers rectangular transfers: rank d owns
  rows [d·n_loc_rows, (d+1)·n_loc_rows) and the aligned column window
  [d·n_loc_cols, (d+1)·n_loc_cols); every column must fall within
  ``halo`` of that window (aggregates are numbered by first fine node,
  so coarse orderings inherit the band).
- :class:`HaloELL`, the port of ``HaloELL``: the same rows, window and
  halo for an :class:`~tpu_amg_torch.sparse.ell.ELL`, whose local ELL
  keeps the JAX package's ``cols_local`` and applies through its capped
  CSR with K1 + K2, as a ``HaloCSR`` does.
- :class:`HaloDIA`, a square matrix stored by diagonals, applied with
  K3.  The port's ``DIA`` is square, so the local form is a square DIA
  of n_loc + 2·halo rows whose halo rows are zero, applied to the
  buffer, output rows [halo, halo + n_loc) kept: 2·halo rows of zeros
  read and written more than the rank's own rows.

Setup checks the band and raises ``ValueError`` otherwise; the callers
(:mod:`tpu_amg_torch.parallel.dist`) then fall back to the all-gather
path, where the JAX package falls back.  One rank has no neighbour, so
its halo is 0 and its local operator is the whole matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_amg_torch.linop import LinearOperator, _apply
from tpu_amg_torch.ops.spmv import CappedCSR
from tpu_amg_torch.shard_utils import SolverGroup, host_staged, unstage
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA, dia_from_arrays
from tpu_amg_torch.sparse.ell import ELL, to_host


def ring_exchange(x: torch.Tensor, halo: int,
                  group: SolverGroup) -> torch.Tensor:
    """The [left halo | x | right halo] buffer of this rank's rows ``x``.

    Two point-to-point transfers a neighbour (``batch_isend_irecv``): the
    last ``halo`` rows to the next rank, the first ``halo`` to the
    previous one.  The ends of the row order have no neighbour there
    and get zeros: the band check in ``from_*`` guarantees that no row
    reads columns past the global edges.  At ``halo == 0`` or one rank it
    is the pad alone, with no call."""
    if halo == 0:
        return x
    pad = (halo,) + tuple(x.shape[1:])
    left, right = x.new_zeros(pad), x.new_zeros(pad)
    if group.size == 1:
        return torch.cat([left, x, right])
    i, last = group.index, group.size - 1
    ops, recvs = [], []
    for peer, send, recv in ((i - 1, x[:halo], left), (i + 1, x[-halo:], right)):
        if 0 <= peer <= last:
            buf = host_staged(group, recv)
            ops += [dist.P2POp(dist.isend, host_staged(group, send.contiguous()),
                               group=group.group, group_peer=peer),
                    dist.P2POp(dist.irecv, buf, group=group.group,
                               group_peer=peer)]
            recvs.append((buf, recv))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, recv in recvs:
        if buf is not recv:
            recv.copy_(unstage(buf, recv))
    return torch.cat([left, x, right])


def exchange_bytes(halo: int, group: SolverGroup, k: int,
                   dtype: torch.dtype) -> int:
    """Bytes that cross between ranks in one apply at k columns: two
    slabs of ``halo`` rows at each of the size − 1 boundaries."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * (group.size - 1) * halo * k * itemsize


def _check_divisible(nrows: int, ncols: int, n: int):
    if nrows % n or ncols % n:
        raise ValueError(f"shape ({nrows}, {ncols}) not divisible by {n} ranks")


def needed_halo(csr: CSR, n_parts: int) -> int:
    """The halo that the stored entries of ``csr`` need when its rows and
    columns are cut into ``n_parts`` aligned windows."""
    nrows, ncols = csr.shape
    n_loc_rows, n_loc_cols = nrows // n_parts, ncols // n_parts
    rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(csr.indptr))
    offset = csr.indices - (rows // n_loc_rows) * n_loc_cols
    lo = offset.min(initial=0)
    hi = offset.max(initial=0) - (n_loc_cols - 1)
    return int(max(-lo, hi, 0))


@dataclasses.dataclass
class HaloCSR(LinearOperator):
    """Row-sharded (possibly rectangular) CSR whose local columns index
    the halo buffer: ``local`` holds this rank's rows with column c at
    c − window start + halo."""

    local: CappedCSR
    shape: Tuple[int, int]
    nnz: int
    halo: int
    group: SolverGroup
    block_size: int = 1

    @property
    def n_loc_rows(self) -> int:
        return self.shape[0] // self.group.size

    @property
    def n_loc_cols(self) -> int:
        return self.shape[1] // self.group.size

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @staticmethod
    def from_csr(csr: CSR, group: SolverGroup, device,
                 dtype=torch.float64, halo: int = None) -> "HaloCSR":
        """This rank's block of a host CSR; raises ``ValueError`` when a
        stored entry falls outside the halo band."""
        n = group.size
        nrows, ncols = csr.shape
        _check_divisible(nrows, ncols, n)
        n_loc_rows, n_loc_cols = nrows // n, ncols // n
        needed = needed_halo(csr, n)
        halo = needed if halo is None else halo
        if needed > halo or halo > n_loc_cols:
            raise ValueError(f"band assumption violated: needs halo {needed},"
                             f" local column window {n_loc_cols}")
        lo, hi = csr.indptr[group.index * n_loc_rows], \
            csr.indptr[(group.index + 1) * n_loc_rows]
        rows = slice(group.index * n_loc_rows, (group.index + 1) * n_loc_rows + 1)
        local = CSR(
            data=csr.data[lo:hi],
            indices=(csr.indices[lo:hi] - group.index * n_loc_cols
                     + halo).astype(np.int32),
            indptr=csr.indptr[rows] - lo,
            shape=(n_loc_rows, n_loc_cols + 2 * halo),
        )
        return HaloCSR(local=CappedCSR.from_csr(local, device, dtype),
                       shape=tuple(csr.shape), nnz=csr.nnz, halo=halo,
                       group=group, block_size=csr.block_size)

    def mv(self, x):
        return halo_spmv(self, x)

    def mm(self, xs):
        return halo_spmv(self, xs)


@dataclasses.dataclass
class HaloELL(LinearOperator):
    """Row-sharded (possibly rectangular) ELL: ``local`` holds this
    rank's rows with ``cols_local = cols − window start + halo`` (padded
    slots at the window's first column), the JAX package's layout, and
    its capped CSR the same rows' stored entries in buffer columns."""

    local: ELL
    shape: Tuple[int, int]
    nnz: int
    halo: int
    group: SolverGroup
    block_size: int = 1

    @property
    def n_loc_rows(self) -> int:
        return self.shape[0] // self.group.size

    @property
    def n_loc_cols(self) -> int:
        return self.shape[1] // self.group.size

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def k(self) -> int:
        return self.local.k

    @staticmethod
    def from_ell(ell: ELL, group: SolverGroup,
                 halo: int = None) -> "HaloELL":
        """This rank's block of ``ell`` (every rank holds the whole
        matrix), on its device; raises ``ValueError`` when a non-zero
        slot falls outside the halo band (the JAX package's check)."""
        n = group.size
        nrows, ncols = ell.shape
        _check_divisible(nrows, ncols, n)
        n_loc_rows, n_loc_cols = nrows // n, ncols // n
        data, cols = to_host(ell.data), to_host(ell.cols).astype(np.int64)
        rows = np.arange(nrows, dtype=np.int64)[:, None]
        offset = cols - (rows // n_loc_rows) * n_loc_cols
        valid = data != 0
        lo = offset[valid].min(initial=0)
        hi = offset[valid].max(initial=0) - (n_loc_cols - 1)
        needed = int(max(-lo, hi, 0))
        halo = needed if halo is None else halo
        if needed > halo or halo > n_loc_cols:
            raise ValueError(f"band assumption violated: needs halo {needed},"
                             f" local column window {n_loc_cols}")
        mine = group.rows(nrows)
        cols_local = (np.where(valid, offset, 0)[mine] + halo).astype(np.int32)
        # the capped CSR's rows: its stored zeros outside the band (which
        # no product needs) are dropped, the rest shifted to the buffer
        csr = ell.capped.to_csr()
        lo_e, hi_e = csr.indptr[mine.start], csr.indptr[mine.stop]
        r = np.repeat(np.arange(n_loc_rows), np.diff(
            csr.indptr[mine.start:mine.stop + 1]))
        c = csr.indices[lo_e:hi_e].astype(np.int64) \
            - group.index * n_loc_cols + halo
        v = csr.data[lo_e:hi_e]
        width = n_loc_cols + 2 * halo
        keep = (c >= 0) & (c < width)
        local_csr = CSR.from_coo(r[keep], c[keep], v[keep],
                                 (n_loc_rows, width))
        local = ELL(data=ell.data[mine].contiguous(),
                    cols=torch.from_numpy(cols_local).to(ell.device),
                    shape=(n_loc_rows, width), nnz=local_csr.nnz,
                    block_size=ell.block_size,
                    capped=CappedCSR.from_csr(local_csr, ell.device,
                                              ell.dtype))
        return HaloELL(local=local, shape=tuple(ell.shape), nnz=ell.nnz,
                       halo=halo, group=group, block_size=ell.block_size)

    def mv(self, x):
        return halo_spmv(self, x)

    def mm(self, xs):
        return halo_spmv(self, xs)


@dataclasses.dataclass
class HaloDIA(LinearOperator):
    """Row-sharded square DIA: a local square DIA of n_loc + 2·halo rows
    (this rank's rows of every diagonal at rows [halo, halo + n_loc),
    zeros around them) applied with K3 to the halo buffer."""

    local: DIA
    shape: Tuple[int, int]
    nnz: int
    halo: int
    group: SolverGroup
    block_size: int = 1

    @property
    def n_loc_rows(self) -> int:
        return self.shape[0] // self.group.size

    n_loc_cols = n_loc_rows

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self.local.offsets

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @staticmethod
    def from_dia(dia: DIA, group: SolverGroup) -> "HaloDIA":
        """This rank's rows of ``dia`` (on its device); raises
        ``ValueError`` when an offset passes the local window."""
        n = dia.nrows
        _check_divisible(n, n, group.size)
        n_loc = n // group.size
        halo = max((abs(o) for o in dia.offsets), default=0)
        halo = halo if group.size > 1 else 0
        if halo > n_loc:
            raise ValueError(f"band assumption violated: diagonal offset "
                             f"{halo} exceeds local window {n_loc}")
        data = dia.data.new_zeros((len(dia.offsets), n_loc + 2 * halo))
        data[:, halo:halo + n_loc] = dia.data[:, group.rows(n)]
        local = dia_from_arrays(data, dia.offsets, (n_loc + 2 * halo,) * 2,
                                int((data != 0).sum()), dia.device,
                                dia.dtype, dia.block_size)
        return HaloDIA(local=local, shape=tuple(dia.shape), nnz=dia.nnz,
                       halo=halo, group=group, block_size=dia.block_size)

    def mv(self, x):
        return halo_spmv(self, x)

    def mm(self, xs):
        return halo_spmv(self, xs)


def halo_spmv(h, x: torch.Tensor) -> torch.Tensor:
    """y = A x for this rank's rows ``x`` (n_loc_cols, or (n_loc_cols,
    k)): the ring exchange, then K1 + K2 (:class:`HaloCSR`,
    :class:`HaloELL`) or K3 (:class:`HaloDIA`) on the buffer; returns
    this rank's rows of y."""
    xbuf = ring_exchange(x, h.halo, h.group)
    y = _apply(h.local, xbuf)
    if isinstance(h, HaloDIA) and h.halo:
        y = y[h.halo:h.halo + h.n_loc_rows]
    return y
