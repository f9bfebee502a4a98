"""K3 (dia_spmv) and the DIA format of the port (tpu_amg_torch.sparse.dia).

Mirrors tests/test_dia.py case for case.  On the CPU the wrapper runs
K3's plain version; these tests hold it against the host CSR oracle,
against the JAX package's ``DIA.mv``/``mm`` (carried across with
``dia_from_arrays``), and against the DIA Pallas kernel itself in
interpret mode (``dia_spmv_pallas(..., interpret=True)``).  Tolerances:
1e-12 relative in float64 (the same sums, up to fused multiply-adds),
1e-5 in float32.  The format choice of ``SparseOperator.from_csr`` is
held against the JAX package's ``_pick_format``.  The CUDA cases run
the kernel itself and skip without a card.

K3's band-tile design (k >= 8) is held on the CPU through its plan:
``dia_plan`` walked in numpy (every output written once, every in-range
product read inside its band's staged window, the diagonals in offset
order, the windows inside the budget, the grid two blocks an SM where n
allows), and the kernel's per-tile sum restated in numpy from that plan
against the plain version.

K3's row-chunk design (k < 8) is held the same way: ``row_plan`` and
every launch of ``row_plans`` walked in numpy (each row owned by one
thread, a diagonal's R values one aligned vector load, the chunks in
offset order), and the kernel's sum restated in numpy from that plan (R
rows a thread, chunks of U diagonals, every read issued at a clamped
row and set to NaN where it lies outside the matrix, so that a read
that is not skipped shows) against the plain version.

On the card the routed designs are held against the plain version,
bitwise against the first design at every (values, vectors) pair and
bitwise across two calls; every launch of ``row_plans`` gives the first
design's bits, on aligned and unaligned data and on an X with NaN and
Inf where only skipped reads reach it; the wrapper never takes the
plain version for a CUDA tensor; and a CUDA graph replays the row-chunk
design on new X with the eager bits.

JAX is imported inside the tests that use it, so that on a machine with
a card and no JAX the CUDA cases run with
``python -m pytest --noconftest tests/test_torch_dia.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.ops import dia as dia_ops
from tpu_amg_torch.ops.spmv import PAIRS, CappedCSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA, dia_from_arrays, try_from_csr
from tpu_amg_torch.utils.problems import (
    anisotropic_diffusion_2d,
    poisson1d,
    poisson2d,
    poisson3d,
    unstructured_poisson_3d,
)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def _close(got, ref, rtol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _jax_csr(csr: CSR):
    from tpu_amg.sparse.csr import CSR as JaxCSR

    return JaxCSR(data=csr.data, indices=csr.indices, indptr=csr.indptr,
                  shape=csr.shape, block_size=csr.block_size)


def _jax_dia(csr: CSR, dtype, max_diags=32):
    import jax.numpy as jnp

    from tpu_amg.sparse.dia import try_from_csr as jax_try_from_csr

    return jax_try_from_csr(_jax_csr(csr), dtype=jnp.dtype(NP[dtype]),
                            max_diags=max_diags)


def _across(jax_dia, dtype):
    """The JAX package's DIA as the port's, through numpy arrays."""
    return dia_from_arrays(np.asarray(jax_dia.data), jax_dia.offsets,
                           jax_dia.shape, jax_dia.nnz, "cpu", dtype)


def _x(n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k == 1 else (n, k)).astype(NP[dtype])


def anisotropic16(_side=None) -> CSR:
    """The 9-diagonal stencil of the adaptive path's fine A, at 16²:
    anisotropic_diffusion_2d(16, coefficient="random")."""
    return anisotropic_diffusion_2d(16, coefficient="random")


@functools.cache
def _galerkin_level(side: int) -> CSR:
    """Level 1 of the structured multigrid on poisson3d(side): the
    smoothed-aggregation Galerkin product, 33 diagonals in 3-D."""
    from tpu_amg_torch.interpolation.sa import smooth_interpolation
    from tpu_amg_torch.sparse.ops import spgemm
    from tpu_amg_torch.structured import StructuredInterp, structured_partition

    a = poisson3d(side)
    part, cs = structured_partition((side,) * 3)
    sizes = part.agg_sizes()
    w = 1.0 / np.sqrt(sizes[part.node_to_agg].astype(np.float64))
    p = StructuredInterp(torch.from_numpy(w), (side,) * 3, cs).to_csr()
    p = smooth_interpolation(a, p, 0.66)
    return spgemm(p.transpose(), spgemm(a, p))


class TestDIA:
    @pytest.mark.parametrize("gen", [poisson1d, poisson2d, poisson3d])
    def test_spmv_matches_oracle(self, gen):
        a = gen(5)
        dia = try_from_csr(a, "cpu")
        assert dia is not None
        x = np.random.default_rng(0).normal(size=a.ncols)
        np.testing.assert_allclose(
            dia.mv(torch.from_numpy(x)).numpy(), a.matvec(x), rtol=1e-12
        )

    def test_spmm_matches(self):
        a = poisson2d(6)
        dia = try_from_csr(a, "cpu")
        xs = np.random.default_rng(1).normal(size=(36, 5))
        np.testing.assert_allclose(
            dia.mm(torch.from_numpy(xs)).numpy(), a.to_dense() @ xs,
            rtol=1e-12,
        )

    def test_diagonal_and_row_sums(self):
        a = poisson3d(3)
        dia = try_from_csr(a, "cpu")
        np.testing.assert_allclose(dia.diagonal().numpy(), a.diagonal())
        np.testing.assert_allclose(dia.abs_row_sums().numpy(),
                                   a.abs_row_sums())
        np.testing.assert_allclose(dia.row_sums().numpy(), a.row_sums())

    def test_too_many_diagonals_returns_none(self):
        rng = np.random.default_rng(2)
        n = 64
        rows = rng.integers(0, n, 400)
        cols = rng.integers(0, n, 400)
        a = CSR.from_coo(rows, cols, np.ones(400), (n, n))
        assert try_from_csr(a, "cpu", max_diags=8) is None
        assert try_from_csr(a, "cpu", max_diags=None) is not None

    def test_non_square_returns_none(self):
        a = CSR.from_dense(np.ones((3, 4)))
        assert try_from_csr(a, "cpu") is None
        with pytest.raises(ValueError):
            DIA.from_csr(a, "cpu")

    def test_wraparound_annihilated(self):
        # offsets ±1 on a small chain: out-of-range reads must not leak
        a = poisson1d(5)  # tridiag 4x4
        dia = try_from_csr(a, "cpu")
        x = np.array([1.0, 10.0, 100.0, 1000.0])
        np.testing.assert_allclose(dia.mv(torch.from_numpy(x)).numpy(),
                                   a.matvec(x))

    def test_astype_and_fields(self):
        a = poisson2d(4, 3)
        dia = try_from_csr(a, "cpu")
        assert dia.offsets == (-3, -1, 0, 1, 3)
        assert dia.offsets_dev.tolist() == list(dia.offsets)
        assert dia.data.shape == (5, 12) and dia.nnz == a.nnz
        f32 = dia.astype(torch.float32)
        assert f32.dtype == torch.float32 and f32.offsets == dia.offsets


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 7, 64, 63])
@pytest.mark.parametrize("gen", [poisson1d, poisson2d, poisson3d,
                                 anisotropic16])
def test_matches_jax_dia(gen, k, dtype):
    import jax.numpy as jnp

    a = gen(9)
    ref = _jax_dia(a, dtype)
    got = _across(ref, dtype)
    own = try_from_csr(a, "cpu", dtype)
    assert own.offsets == got.offsets == tuple(ref.offsets)
    np.testing.assert_array_equal(own.data.numpy(), got.data.numpy())
    x = _x(a.nrows, k, dtype)
    want = ref.mv(jnp.asarray(x)) if k == 1 else ref.mm(jnp.asarray(x))
    _close(got(torch.from_numpy(x)), want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_matches_pallas_interpret(dtype):
    """poisson3d(32): n = 32,768, a multiple of the Pallas kernel's tile."""
    import jax.numpy as jnp

    from tpu_amg.ops.dia_pallas import TILE, dia_spmv_pallas

    a = poisson3d(32)
    assert a.nrows % TILE == 0
    ref = _jax_dia(a, dtype)
    got = _across(ref, dtype)
    x = _x(a.nrows, 1, dtype, seed=3)
    want = np.asarray(dia_spmv_pallas(ref, jnp.asarray(x), interpret=True))
    _close(got.mv(torch.from_numpy(x)), want, TOL[dtype])


def test_galerkin_level_matches_pallas_interpret():
    """A 33-diagonal Galerkin level (16³ rows), zero-padded to a multiple
    of the Pallas kernel's tile as bench.py pads it."""
    import dataclasses

    import jax.numpy as jnp

    from tpu_amg.ops.dia_pallas import TILE, dia_spmv_pallas

    level = _galerkin_level(32)
    ref = _jax_dia(level, torch.float64, max_diags=160)
    assert len(ref.offsets) == 33
    n = level.nrows
    n_pad = -(-n // TILE) * TILE
    assert n_pad != n
    padded = dataclasses.replace(
        ref, data=jnp.pad(ref.data, ((0, 0), (0, n_pad - n))),
        shape=(n_pad, n_pad))
    x = _x(n, 1, torch.float64, seed=4)
    want = np.asarray(dia_spmv_pallas(padded, jnp.pad(jnp.asarray(x),
                                                      (0, n_pad - n)),
                                      interpret=True))[:n]
    got = _across(ref, torch.float64)
    _close(got.mv(torch.from_numpy(x)), want, 1e-12)
    _close(got.mv(torch.from_numpy(x)), level.matvec(x), 1e-12)


FORMAT_CASES = ["poisson1d", "poisson2d", "poisson3d", "galerkin_33",
                "sparse_diagonals", "unstructured", "rectangular"]


def _format_case(name: str) -> CSR:
    """A host CSR for the format-choice comparison."""
    rng = np.random.default_rng(6)
    n = 200
    if name == "sparse_diagonals":  # 4 diagonals, two of them almost empty
        return CSR.from_coo(
            np.r_[np.arange(n), 0, 1, n - 1],
            np.r_[np.arange(n), n - 1, n - 2, 0],
            np.r_[np.full(n, 4.0), -1.0, -1.0, -1.0], (n, n))
    if name == "rectangular":
        return CSR.from_coo(rng.integers(0, 30, 90), rng.integers(0, 20, 90),
                            np.ones(90), (30, 20))
    return {
        "poisson1d": lambda: poisson1d(40),
        "poisson2d": lambda: poisson2d(12),
        "poisson3d": lambda: poisson3d(8),
        "galerkin_33": lambda: _galerkin_level(16),
        "unstructured": lambda: unstructured_poisson_3d(10),
    }[name]()


@pytest.mark.parametrize("envelope", [{}, dict(dia_max_diags=160,
                                                dia_max_density=8.0)])
@pytest.mark.parametrize("name", FORMAT_CASES)
def test_format_choice_matches_jax(name, envelope):
    from tpu_amg.linop import SparseOperator as JaxSparseOperator
    from tpu_amg.sparse.dia import DIA as JaxDIA

    csr = _format_case(name)
    got = SparseOperator.from_csr(csr, "cpu", **envelope)
    ref = JaxSparseOperator.from_csr(_jax_csr(csr), prefer_well=False,
                                     **envelope)
    assert isinstance(got.mat, DIA) == isinstance(ref.ell, JaxDIA)
    if name == "unstructured":
        assert isinstance(got.mat, CappedCSR)
    if name in ("poisson1d", "poisson2d", "poisson3d"):
        assert isinstance(got.mat, DIA)
    if name == "galerkin_33":
        assert isinstance(got.mat, DIA) == bool(envelope)
    x = _x(csr.ncols, 1, torch.float64)
    _close(got.mv(torch.from_numpy(x)), csr.matvec(x), 1e-12)


def test_dia_operator_transpose():
    a = poisson2d(7)
    op = SparseOperator.from_csr(a, "cpu", with_transpose=True)
    assert isinstance(op.mat, DIA) and isinstance(op.mat_t, DIA)
    plain = SparseOperator.from_csr(a, "cpu")
    assert plain.mat_t is None
    x = torch.from_numpy(_x(a.nrows, 3, torch.float64))
    _close(plain.rmm(x), a.to_dense().T @ x.numpy(), 1e-12)
    _close(op.rmv(x[:, 0].contiguous()), a.to_dense().T @ x[:, 0].numpy(),
           1e-12)


def test_wrapper_rejects_bad_input():
    dia = try_from_csr(poisson2d(5), "cpu")
    with pytest.raises(TypeError):
        dia.mv(torch.zeros(25, dtype=torch.float32))
    with pytest.raises(ValueError):
        dia.mv(torch.zeros(24, dtype=torch.float64))
    with pytest.raises(ValueError):
        dia.mm(torch.zeros(25, 65, dtype=torch.float64))
    with pytest.raises(ValueError):
        dia.mm(torch.zeros(3, 25, dtype=torch.float64).T)
    assert dia.mm(torch.zeros(25, 64, dtype=torch.float64)).shape == (25, 64)


def test_no_kernel_off_cpu_and_cuda():
    dia = try_from_csr(poisson2d(3), "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        dia.mv(torch.zeros(9, dtype=torch.float64, device="meta"))


def test_plain_version_does_not_count_launches():
    dia = try_from_csr(poisson3d(4), "cpu")
    before = dia_ops.dia_spmv_launches
    dia.mv(torch.ones(64, dtype=torch.float64))
    assert dia_ops.dia_spmv_launches == before


# ---- K3's band-tile plan, walked on the CPU

SMS = 132  # an H100's SMs


def _offsets_case(name: str):
    """(offsets, n) of a plan case."""
    if name == "adaptive A":  # aniso2d(512): the adaptive path's fine A
        return (-513, -512, -511, -1, 0, 1, 511, 512, 513), 512 ** 2
    if name == "poisson3d(100)":
        return (-10000, -100, -1, 0, 1, 100, 10000), 100 ** 3
    if name == "galerkin_33":
        level = _galerkin_level(16)
        return try_from_csr(level, "cpu", max_diags=None).offsets, level.nrows
    if name == "160 consecutive":
        return tuple(range(-80, 80)), 3000
    if name == "n < T":
        return (-2, -1, 0, 1, 2), 5
    assert name == "n = 1"
    return (0,), 1


def _thread_map(plan, rows: int) -> np.ndarray:
    """How often the kernel's thread map writes each (row, column) of a
    block of ``rows`` rows."""
    hits = np.zeros((rows, plan.k), dtype=np.int64)
    t = np.arange(plan.threads)
    lane, slot = t % plan.lanes, t // plan.lanes
    slots = plan.threads // plan.lanes
    for j in range(plan.rows_per_thread):
        row = slot + j * slots
        for g in range(plan.groups):
            for e in range(plan.vector):
                col = (lane + g * plan.lanes) * plan.vector + e
                ok = (row < rows) & (col < plan.k)
                np.add.at(hits, (row[ok], col[ok]), 1)
    return hits


def _window(plan, band: int, i0, rows):
    """Rows [r0, r1) of a band's X window, as the kernel stages it, for
    a block's rows [i0, i0 + rows) (ints, or numpy arrays of blocks)."""
    d0, d1 = plan.bands[band]
    return (np.maximum(i0 + plan.offsets[d0], 0),
            np.minimum(i0 + rows + plan.offsets[d1 - 1], plan.n))


def _walk(plan) -> None:
    """Every check of the plan that needs no card."""
    n, k, tile = plan.n, plan.k, plan.tile
    vec = 16 // plan.itemsize
    assert plan.threads in dia_ops.BLOCK_THREADS
    assert plan.rows_per_thread in dia_ops.ROWS_PER_THREAD
    assert plan.lanes <= dia_ops.MAX_LANES and plan.groups <= 2
    assert plan.threads // plan.lanes * plan.rows_per_thread == tile
    assert plan.blocks == -(-n // tile)
    for rows in {min(tile, n), n - (plan.blocks - 1) * tile}:
        assert (_thread_map(plan, rows) == 1).all()  # each output once
    # the diagonals in offset order, each in one band
    assert [d for d0, d1 in plan.bands for d in range(d0, d1)] == list(
        range(len(plan.offsets)))
    i0 = np.arange(plan.blocks, dtype=np.int64) * tile
    rows = np.minimum(tile, n - i0)
    for b, (d0, d1) in enumerate(plan.bands):
        r0, r1 = _window(plan, b, i0, rows)
        width = np.maximum(r1 - r0, 0)
        assert (width * k + vec - 1 <= plan.xs_cap).all()  # with its phase
        assert (d1 - d0) * tile <= plan.ds_cap
        for d in range(d0, d1):
            lo = np.maximum(i0 + plan.offsets[d], 0)
            hi = np.minimum(i0 + rows + plan.offsets[d], n)
            some = lo < hi  # the block reads X rows [lo, hi) on diagonal d
            assert (r0[some] <= lo[some]).all() and (hi[some] <= r1[some]).all()
    # two buffers of 16-byte aligned places, each within its budget
    assert plan.xs_cap % vec == 0 and plan.ds_cap % vec == 0
    assert plan.xs_cap * plan.itemsize <= dia_ops.X_BUDGET
    assert plan.ds_cap * plan.itemsize <= dia_ops.DATA_BUDGET
    assert plan.smem_bytes == (2 if len(plan.bands) > 1 else 1) * (
        plan.xs_cap + plan.ds_cap) * plan.itemsize
    tile_min = min(dia_ops.BLOCK_THREADS) // plan.lanes  # a warp, a row a slot
    if n >= 2 * SMS * tile_min:
        assert plan.blocks >= 2 * SMS


PLAN_CASES = ["adaptive A", "poisson3d(100)", "galerkin_33",
              "160 consecutive", "n < T", "n = 1"]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2, 7, 8, 33, 63, 64])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_walk(name, k, dtype, aligned):
    offsets, n = _offsets_case(name)
    plan = dia_ops.dia_plan(offsets, n, k, dtype, SMS, aligned)
    _walk(plan)
    vec = 16 // plan.itemsize
    assert plan.vector == (vec if aligned and k % vec == 0 else 1)


def test_plan_bands_and_grid():
    """The band counts the kernel's design rests on: the adaptive A's 3
    bands at T = 32 (k = 64, f64: a warp a row), poisson3d(100)'s 5;
    160 consecutive offsets cut by the window budget; the tile shrinks
    on a coarse level to keep two blocks an SM."""
    plan = dia_ops.dia_plan(*_offsets_case("adaptive A"), 64, torch.float64,
                            SMS)
    assert (plan.tile, plan.lanes, plan.vector, plan.threads) == (32, 32, 2, 256)
    assert plan.bands == ((0, 3), (3, 6), (6, 9)) and plan.blocks == 8192
    plan = dia_ops.dia_plan(*_offsets_case("poisson3d(100)"), 64,
                            torch.float64, SMS)
    assert len(plan.bands) == 5
    plan = dia_ops.dia_plan(tuple(range(-80, 80)), 3000, 64, torch.float64,
                            SMS)
    assert len(plan.bands) > 1 and plan.tile < 32
    coarse = dia_ops.dia_plan(*_offsets_case("adaptive A")[:1], 5968, 64,
                              torch.float64, SMS)
    assert coarse.tile == 16 and coarse.blocks >= 2 * SMS


def test_plan_rejects():
    with pytest.raises(ValueError, match="strictly increasing"):
        dia_ops.dia_plan((0, -1), 10, 8, torch.float64, SMS)
    with pytest.raises(ValueError, match="up to 160"):
        dia_ops.dia_plan(tuple(range(161)), 1000, 8, torch.float64, SMS)
    with pytest.raises(ValueError, match="strictly increasing"):
        dia_from_arrays(np.ones((2, 4)), (1, 0), (4, 4), 8, "cpu")


def _tile_sum(plan, data: np.ndarray, x: np.ndarray, phase: int = 0):
    """The band-tile kernel's sum restated in numpy from ``plan``: for
    each block and band the X window and data rows staged into a buffer
    (NaN elsewhere, so a read outside what was staged shows), X's base
    at ``phase`` elements past 16 bytes; every output one accumulator,
    the diagonals in offset order."""
    n, k, tile = plan.n, plan.k, plan.tile
    vec = 16 // plan.itemsize
    x = x.reshape(n, k)
    y = np.full((n, k), np.nan, dtype=x.dtype)
    cols = np.arange(k)
    for blk in range(plan.blocks):
        i0 = blk * tile
        rows = min(tile, n - i0)
        acc = np.zeros((rows, k), dtype=x.dtype)
        for b, (d0, d1) in enumerate(plan.bands):
            r0, r1 = (int(v) for v in _window(plan, b, i0, rows))
            buf = np.full(plan.xs_cap + plan.ds_cap, np.nan, dtype=x.dtype)
            pad = (phase + r0 * k) % vec
            if r0 < r1:
                buf[pad:pad + (r1 - r0) * k] = x[r0:r1].ravel()
            for dd in range(d1 - d0):
                at = plan.xs_cap + dd * tile
                buf[at:at + rows] = data[d0 + dd, i0:i0 + rows]
            for d in range(d0, d1):
                row = np.arange(rows)
                src = i0 + row + plan.offsets[d]
                ok = (src >= 0) & (src < n)
                a = buf[plan.xs_cap + (d - d0) * tile + row[ok]]
                xr = buf[pad + (src[ok, None] - r0) * k + cols]
                acc[row[ok]] = acc[row[ok]] + a[:, None] * xr
        y[i0:i0 + rows] = acc
    return y


TILE_SUM_CASES = ["aniso16", "poisson3d", "galerkin_33", "160 consecutive"]


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [2, 7, 33, 63, 64])
@pytest.mark.parametrize("name", TILE_SUM_CASES)
def test_tile_sum_matches_plain(name, k, dtype, phase):
    rng = np.random.default_rng(5)
    if name == "160 consecutive":
        n = 300
        dia = dia_from_arrays(rng.standard_normal((160, n)),
                              tuple(range(-80, 80)), (n, n), 160 * n, "cpu",
                              dtype)
    else:
        csr = {"aniso16": anisotropic16, "poisson3d": lambda: poisson3d(7),
               "galerkin_33": lambda: _galerkin_level(16)}[name]()
        dia = try_from_csr(csr, "cpu", dtype, max_diags=None)
    n = dia.shape[0]
    # small tiles, so that the matrices take many blocks and bands
    plan = dia_ops.dia_plan(dia.offsets, n, k, dtype, 4 * SMS, phase == 0)
    x = _x(n, k, dtype, seed=k)
    got = _tile_sum(plan, dia.data.numpy(), x, phase)
    ref = dia_ops.plain_dia_spmv(dia, torch.from_numpy(x))
    assert np.isfinite(got).all()
    _close(got, ref.numpy(), TOL[dtype])


# ---- K3's row-chunk design (k < 8), walked on the CPU

WALK_CASES = ["aniso16", "poisson3d", "galerkin_33", "160 consecutive"]


def _walk_dia(name: str, dtype):
    if name == "160 consecutive":
        n = 300
        rng = np.random.default_rng(5)
        return dia_from_arrays(rng.standard_normal((160, n)),
                               tuple(range(-80, 80)), (n, n), 160 * n, "cpu",
                               dtype)
    csr = {"aniso16": anisotropic16, "poisson3d": lambda: poisson3d(7),
           "galerkin_33": lambda: _galerkin_level(16)}[name]()
    return try_from_csr(csr, "cpu", dtype, max_diags=None)


def _row_sum(plan, offsets, data: np.ndarray, x: np.ndarray,
             phase: int = 0) -> np.ndarray:
    """The row kernel's sum restated in numpy from ``plan``: thread t
    owns rows [t·R, t·R + R) and all k columns, or (one column a thread)
    row t / k, column t % k; for each chunk of diagonals every value and
    every X element is read first, X at a clamped row whose value is NaN
    where the row lies outside [0, n), then each product is added in
    offset order where its read was in range.  The data's base lies
    ``phase`` elements past 16 bytes: a vector load of R values must be
    aligned to its size."""
    n, k, r_, c_ = plan.n, plan.k, plan.rows_per_thread, plan.cols
    itemsize = data.itemsize
    x = x.reshape(n, k)
    t = np.arange(plan.blocks * plan.threads, dtype=np.int64)
    if c_ == k:
        i0, c0 = t * r_, np.zeros_like(t)
        live = i0 < n
    else:
        i0, c0 = t // k, t % k
        live = t < n * k
    i0, c0 = i0[live], c0[live]
    rows = i0[:, None] + np.arange(r_)           # (threads, R)
    cols = c0[:, None] + np.arange(c_)           # (threads, C)
    acc = np.zeros((len(i0), r_, c_), dtype=x.dtype)
    nd = len(offsets)
    order, d0 = [], 0
    for size in dia_ops.row_chunks(nd, plan.chunk):
        chunk = list(range(d0, d0 + size))
        d0 += size
        order += chunk
        reads = []
        for d in chunk:  # every load of the chunk first
            if r_ > 1:
                assert (((phase + d * n + i0) * itemsize)
                        % min(16, r_ * itemsize) == 0).all()
            j = rows + offsets[d]
            inside = (j >= 0) & (j < n)
            xs = x[np.clip(j, 0, n - 1)[:, :, None], cols[:, None, :]]
            xs[~inside] = np.nan
            reads.append((data[d, rows], xs, inside))
        for a, xs, inside in reads:  # then the fmas, offset order
            acc = np.where(inside[..., None], acc + a[..., None] * xs, acc)
    assert order == list(range(nd))
    y = np.full((n, k), np.nan, dtype=x.dtype)
    hits = np.zeros((n, k), dtype=np.int64)
    rr = np.broadcast_to(rows[:, :, None], acc.shape)
    cc = np.broadcast_to(cols[:, None, :], acc.shape)
    np.add.at(hits, (rr, cc), 1)
    assert (hits == 1).all()  # each output written once
    y[rr, cc] = acc
    return y


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("name", WALK_CASES)
def test_row_sum_matches_plain(name, k, dtype, phase):
    """Every launch the plan may take (R = 2 or 1 at k = 1, all k columns
    or one above; 256, 128, 64 threads), aligned data and data one
    element past 16 bytes."""
    dia = _walk_dia(name, dtype)
    n = dia.shape[0]
    x = _x(n, k, dtype, seed=k)
    ref = dia_ops.plain_dia_spmv(dia, torch.from_numpy(x)).numpy()
    plans = dia_ops.row_plans(n, len(dia.offsets), k, phase == 0)
    assert {(p.rows_per_thread, p.cols) for p in plans} == {
        (r, c) for r, c in dia_ops.row_shapes(k)
        if r == 1 or (phase == 0 and n % r == 0)}
    data = dia.data.numpy()
    for plan in plans:
        got = _row_sum(plan, dia.offsets, data, x, phase)
        assert np.isfinite(got).all()
        _close(got.reshape(ref.shape), ref, TOL[dtype])


# The shapes K3 runs below k = 8 on the port's paths: (rows, diagonals,
# k, values' dtype, X's dtype) -> (R, columns a thread, threads) of the
# plan on an H100's 132 SMs
PATH_SHAPES = {
    (1_000_000, 7, 1, "float64", "float64"): (1, 1, 256),    # structured A0
    (1_000_000, 7, 1, "bfloat16", "float32"): (2, 1, 256),   # bf16 values
    (125_000, 33, 1, "float64", "float64"): (1, 1, 256),     # structured A1
    (262_144, 9, 1, "float64", "float64"): (1, 1, 256),      # adaptive fine A
    (262_144, 7, 1, "float32", "float32"): (2, 1, 256),      # bench_vcycle A0
    (32_768, 33, 1, "float32", "float32"): (1, 1, 64),       # bench_vcycle A1
    (102_400, 5, 1, "float64", "float64"): (1, 1, 256),      # classical A0
    (102_400, 5, 5, "float64", "float64"): (1, 1, 256),      # one column
    (260_100, 21, 1, "float32", "float32"): (2, 1, 256),     # real-FEM A0
    (520_000, 7, 1, "float64", "float64"): (1, 1, 256),      # the halo block
}


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_row_plan_on_the_paths(shape):
    n, nd, k, vname, tname = shape
    plan = dia_ops.row_plan(n, nd, k, getattr(torch, tname), SMS,
                            value_dtype=getattr(torch, vname))
    assert (plan.rows_per_thread, plan.cols, plan.threads) == \
        PATH_SHAPES[shape]
    assert plan.blocks >= 2 * SMS
    assert plan.chunk == dia_ops.row_chunk(plan.cols, plan.rows_per_thread)


# (rows, diagonals, k, X's dtype) -> columns a thread: one where an X row
# passes 32 bytes on a short stencil, else all k, whatever n
COLUMN_CASES = {
    (102_400, 5, 5, "float64"): 1,      # classical A0 at k = 5
    (102_400, 5, 5, "float32"): 5,      # 20-byte rows
    (102_400, 5, 4, "float64"): 4,      # 32-byte rows
    (1_000_000, 7, 7, "float64"): 1,    # structured A0: 7 diagonals
    (262_144, 9, 5, "float64"): 5,      # the fine A: 9 diagonals
    (125_000, 33, 5, "float64"): 5,     # structured A1
    (32_768, 33, 5, "float64"): 5,      # bench_vcycle A1: 33 diagonals
}


@pytest.mark.parametrize("shape", list(COLUMN_CASES))
def test_row_plan_columns(shape):
    n, nd, k, tname = shape
    plan = dia_ops.row_plan(n, nd, k, getattr(torch, tname), SMS)
    assert plan.cols == COLUMN_CASES[shape]


@pytest.mark.parametrize("pair", list(PAIRS), ids=list(PAIRS.values()))
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5, 7])
@pytest.mark.parametrize("n", [1, 5, 63, 4_096, 16_896, 16_897, 33_792,
                               135_168, 1_000_000])
def test_row_plan_grid(n, k, aligned, pair):
    """Every output covered, (R, C) one of the kernel's instances, R = 2
    only on aligned data with n even and two values in at most
    ROW_VALUE_BYTES, the chunk within the load budget, and two blocks an
    SM where the ladder has a launch that gives them."""
    vdtype, dtype = pair
    plan = dia_ops.row_plan(n, 9, k, dtype, SMS, aligned, vdtype)
    r, c = plan.rows_per_thread, plan.cols
    assert (r, c) in dia_ops.row_shapes(k)
    assert plan.threads in dia_ops.ROW_THREADS
    assert r == 1 or (aligned and n % r == 0)
    itemsize = torch.empty((), dtype=vdtype).element_size()
    assert r == 1 or r * itemsize <= dia_ops.ROW_VALUE_BYTES
    per_block = plan.threads * r * c  # outputs a block
    assert plan.blocks == -(-n * k // per_block)
    assert (plan.blocks - 1) * per_block < n * k
    assert 1 <= plan.chunk <= dia_ops.ROW_MAX_CHUNK
    assert plan.chunk == 1 or plan.chunk * r * (c + 1) <= dia_ops.ROW_LOADS
    assert plan.chunk & (plan.chunk - 1) == 0
    ladder = [p for p in dia_ops.row_plans(n, 9, k, aligned)
              if (p.rows_per_thread * itemsize <= dia_ops.ROW_VALUE_BYTES
                  or p.rows_per_thread == 1) and p.cols == c]
    assert plan == next((p for p in ladder if p.blocks >= 2 * SMS),
                        ladder[-1])
    if n * k >= 2 * SMS * 64 * c:  # the smallest block: 64 threads
        assert plan.blocks >= 2 * SMS


def test_row_plan_rejects():
    f64 = torch.float64
    with pytest.raises(ValueError, match="up to 160"):
        dia_ops.row_plan(1000, 161, 1, f64, SMS)
    for k in (0, 8, 64):
        with pytest.raises(ValueError, match="1 <= k <= 7"):
            dia_ops.row_plan(1000, 7, k, f64, SMS)
    with pytest.raises(ValueError, match="32-bit rows"):
        dia_ops.row_plan(2**30, 7, 1, f64, SMS)
    assert dia_ops.row_plan(1000, 160, 7, f64, SMS).n_diags == 160


def test_row_chunks():
    """U by (C, R): a power of two, at most 32 loads a thread in flight
    and 16 diagonals; the chunks after the full ones halve."""
    got = {(c, r): dia_ops.row_chunk(c, r) for k in range(1, 8)
           for r, c in dia_ops.row_shapes(k)}
    assert got == {(1, 2): 8, (1, 1): 16, (2, 1): 8, (3, 1): 8, (4, 1): 4,
                   (5, 1): 4, (6, 1): 4, (7, 1): 4}
    assert dia_ops.TILED_MIN_K == dia_ops.ROW_MAX_K + 1
    assert dia_ops.row_chunks(9, 16) == (8, 1)
    assert dia_ops.row_chunks(33, 16) == (16, 16, 1)
    assert dia_ops.row_chunks(7, 4) == (4, 2, 1)
    assert dia_ops.row_chunks(21, 8) == (8, 8, 4, 1)
    for nd in range(0, 161):
        for u in (1, 2, 4, 8, 16):
            sizes = dia_ops.row_chunks(nd, u)
            assert sum(sizes) == nd and all(s <= u for s in sizes)
            tail = sizes[nd // u:]
            assert list(tail) == sorted(set(tail), reverse=True)


def test_row_struct_carries_the_offsets():
    offsets = (-513, -512, -511, -1, 0, 1, 511, 512, 513)
    s = dia_ops._row_struct(offsets)
    assert s.n_diags == 9 and tuple(s.offsets[:9]) == offsets
    assert dia_ops._row_struct(offsets) is s  # cached, as the band plan


def test_sweep_sets_and_arithmetic():
    """tools.diasweep: its offset sets' bands at k = 64, float64, 262,144
    rows (one band but the adaptive A's 3), the bytes it bounds by and
    its µs per added diagonal."""
    from tpu_amg_torch.tools import diasweep

    n = diasweep.FINE_N ** 2
    bands = {name: len(dia_ops.dia_plan(offs, n, diasweep.SWEEP_K,
                                        torch.float64, SMS).bands)
             for name, offs in diasweep.SWEEP_SETS.items()}
    assert bands == {"{0}": 1, "{-1, 0, 1}": 1, "9-point": 3, "-4..4": 1}
    assert diasweep.dia_bytes(n, 9, 64, 8) == (9 * n + 2 * n * 64) * 8
    assert abs(diasweep.data_us_per_diagonal(n) - 0.626) < 1e-3
    times = {"{0}": 0.1, "{-1, 0, 1}": 0.104, "9-point": 0.132,
             "-4..4": 0.116}
    slopes = diasweep.per_diagonal_us(times)
    assert slopes == pytest.approx({"{-1, 0, 1}": 2.0, "9-point": 4.0,
                                    "-4..4": 2.0})


def test_sweep_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("runs the whole sweep on a card")
    from tpu_amg_torch.tools import diasweep

    assert diasweep.main(["--reps", "1"]) == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_KS = [1, 2, 7, 8, 33, 63, 64]
CARD_MATRICES = ["poisson1d", "poisson3d", "galerkin_33", "aniso"]


def _card_csr(name: str) -> CSR:
    return {"poisson1d": lambda: poisson1d(1000),
            "poisson3d": lambda: poisson3d(20),
            "galerkin_33": lambda: _galerkin_level(20),
            # the adaptive path's 9-diagonal stencil, 4,096 rows
            "aniso": lambda: anisotropic_diffusion_2d(
                64, coefficient="random")}[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", CARD_KS)
@pytest.mark.parametrize("name", CARD_MATRICES)
def test_kernel_matches_plain_on_card(cuda, name, k, dtype):
    csr = _card_csr(name)
    dia = try_from_csr(csr, cuda, dtype, max_diags=None)
    x = torch.from_numpy(_x(csr.nrows, k, dtype)).to(cuda)
    before = dia_ops.dia_spmv_launches
    y = dia(x)
    ref = dia_ops.plain_dia_spmv(dia, x)
    torch.cuda.synchronize()
    assert dia_ops.dia_spmv_launches == before + 1
    assert float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["contiguous", "8-byte aligned"])
@pytest.mark.parametrize("pair", list(PAIRS), ids=list(PAIRS.values()))
@pytest.mark.parametrize("k", CARD_KS)
@pytest.mark.parametrize("name", CARD_MATRICES)
def test_kernel_bitwise_first_design_on_card(cuda, name, k, pair, view):
    """K3 as routed (the row-chunk design below k = 8, the band tiles
    from 8 up) gives the first design's bits at each (values, vectors)
    pair, and the same bits on a second call; so does the design not
    routed at that k; also on an X that starts one element past a
    16-byte boundary (a row slice of a flat buffer)."""
    vdtype, dtype = pair
    csr = _card_csr(name)
    dia = try_from_csr(csr, cuda, torch.float64, max_diags=None).astype(vdtype)
    xh = torch.from_numpy(_x(csr.nrows, k, dtype))
    if view == "8-byte aligned":
        flat = torch.zeros(xh.numel() + 1, dtype=dtype, device=cuda)
        flat[1:] = xh.reshape(-1).to(cuda)
        x = flat[1:].view(xh.shape)
        assert x.data_ptr() % 16 != 0
    else:
        x = xh.to(cuda)
    y = dia(x)
    again = dia(x)
    first = dia_ops.launch_first_design(dia, x)
    tiles = dia_ops.launch_band_tiles(dia, x)
    rows = dia_ops.launch_row_design(dia, x) if k <= dia_ops.ROW_MAX_K else y
    ref = dia_ops.plain_dia_spmv(dia, x)
    torch.cuda.synchronize()
    assert torch.equal(y, first) and torch.equal(y, again)
    assert torch.equal(tiles, first) and torch.equal(rows, first)
    assert float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


@pytest.mark.cuda
def test_band_tiles_in_a_graph_on_card(cuda):
    """K3 at k = 64 captured in a CUDA graph and replayed on new X: the
    plan rides in the launch, and the replay gives the eager bits."""
    csr = _card_csr("aniso")
    dia = try_from_csr(csr, cuda, torch.float64)
    x = torch.from_numpy(_x(csr.nrows, 64, torch.float64)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dia(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dia(x)
    x.copy_(torch.from_numpy(_x(csr.nrows, 64, torch.float64, seed=9)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, dia_ops.launch_first_design(dia, x))


@pytest.mark.cuda
def test_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (more shared memory than a block may
    have) raises; nothing falls back."""
    csr = _card_csr("aniso")
    dia = try_from_csr(csr, cuda, torch.float64)
    x = torch.from_numpy(_x(csr.nrows, 64, torch.float64)).to(cuda)
    plan = dia_ops.plan_for(dia, x)
    monkeypatch.setattr(dia_ops, "plan_for", lambda mat, xx: dataclasses.replace(
        plan, smem_bytes=1 << 20))
    with pytest.raises(RuntimeError, match="dia_spmv failed"):
        dia(x)


# ---- K3's row-chunk design on the card

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _card_dia(name, cuda, vdtype, data_phase):
    """The card matrix ``name`` with values of ``vdtype``; at
    ``data_phase`` 1 its diagonals start one element past an aligned
    address (a view of a flat buffer)."""
    dia = try_from_csr(_card_csr(name), cuda, torch.float64,
                       max_diags=None).astype(vdtype)
    if data_phase:
        flat = torch.zeros(dia.data.numel() + 1, dtype=vdtype, device=cuda)
        flat[1:] = dia.data.reshape(-1)
        dia.data = flat[1:].view(dia.data.shape)
        assert dia.data.data_ptr() % 16
    return dia


@pytest.mark.cuda
@pytest.mark.parametrize("data_phase", [0, 1])
@pytest.mark.parametrize("pair", list(PAIRS), ids=list(PAIRS.values()))
@pytest.mark.parametrize("k", [1, 2, 5, 7])
@pytest.mark.parametrize("name", ["poisson1d", "galerkin_33", "aniso"])
def test_row_plans_bitwise_first_design_on_card(cuda, name, k, pair,
                                                 data_phase):
    """Every launch of ``row_plans`` (each R and block) gives the first
    design's bits; the routed call too, within T's tolerance of the
    plain version."""
    vdtype, dtype = pair
    if data_phase and vdtype == torch.bfloat16:
        pytest.skip("the kernels take 4-byte aligned diagonals only")
    dia = _card_dia(name, cuda, vdtype, data_phase)
    x = torch.from_numpy(_x(dia.shape[0], k, dtype)).to(cuda)
    first = dia_ops.launch_first_design(dia, x)
    routed = dia(x)
    plain = dia_ops.plain_dia_spmv(dia, x)
    outs = [dia_ops.launch_row_design(dia, x, plan) for plan in
            dia_ops.row_plans(dia.shape[0], len(dia.offsets), k,
                              data_phase == 0)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, first) for y in outs + [routed])
    scale = float(plain.abs().max())
    assert float((routed - plain).abs().max()) <= TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_row_design_skips_nonfinite_reads_on_card(cuda, k, dtype):
    """NaN and Inf in X rows that rows near the ends read only out of
    range (clamped, skipped): the first design's bits, NaN for NaN."""
    dia = try_from_csr(_card_csr("galerkin_33"), cuda, dtype,
                       max_diags=None)
    x = torch.from_numpy(_x(dia.shape[0], k, dtype)).to(cuda)
    x[0] = float("nan")
    x[-1] = float("inf")
    y = dia(x)
    first = dia_ops.launch_first_design(dia, x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(first))
    assert torch.isfinite(y).any() and not torch.isfinite(y).all()


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    """Every k from 1 to 64 launches a kernel and counts it; the plain
    version is never called for a CUDA tensor."""
    dia = try_from_csr(_card_csr("aniso"), cuda, torch.float64)

    def refuse(*_):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(dia_ops, "plain_dia_spmv", refuse)
    for k in (1, 2, 7, 8, 64):
        x = torch.from_numpy(_x(dia.shape[0], k, torch.float64)).to(cuda)
        before = dia_ops.dia_spmv_launches
        shape = dia_ops.dia_spmv_launches_by_shape[(*dia.shape, k)]
        y = dia(x)
        torch.cuda.synchronize()
        assert y.is_cuda and dia_ops.dia_spmv_launches == before + 1
        assert dia_ops.dia_spmv_launches_by_shape[(*dia.shape, k)] == \
            shape + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_row_design_in_a_graph_on_card(cuda, k):
    """K3 below k = 8 captured in a CUDA graph and replayed on new X:
    the offsets ride in the launch, and the replay gives the eager
    bits."""
    csr = _card_csr("aniso")
    dia = try_from_csr(csr, cuda, torch.float64)
    x = torch.from_numpy(_x(csr.nrows, k, torch.float64)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dia(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dia(x)
    x.copy_(torch.from_numpy(_x(csr.nrows, k, torch.float64, seed=9)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, dia_ops.launch_first_design(dia, x))


def test_row_design_refuses_a_foreign_plan():
    """launch_row_design takes only a plan of ``row_plans`` for this
    matrix and X (R > 1 needs its aligned vector loads)."""
    dia = try_from_csr(poisson3d(4), "cpu")
    x = torch.ones(64, dtype=torch.float64)
    other = dia_ops.row_plan(128, 7, 1, torch.float64, 1)
    with pytest.raises(ValueError, match="no row-chunk plan"):
        dia_ops.launch_row_design(dia, x, other)
