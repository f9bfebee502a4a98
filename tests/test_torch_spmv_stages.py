"""K1's stage ablations ``csr_spmv_stages`` (tpu_amg_torch.ops.spmv_stages),
their matrix ``unstructured_fem_system`` and their command line
(tpu_amg_torch.tools.wellablate).

The port's matrix equals ``bench.unstructured_fem_system`` exactly.  The
plain ``full`` mode is held against the JAX WELL prototypes W1
(``tools/well2proto.py`` ``v3_call``) and W3 (``v2_call``) in interpret
mode; every other mode's plain version against a numpy statement of its
definition.  ``tools/wellablate2.py`` runs at import and is never
imported here.  The CUDA cases run the kernel and skip without a card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_amg_torch.ops import spmv, spmv_stages
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.tools import wellablate
from tpu_amg_torch.utils.problems import unstructured_fem_system

ROOT = Path(__file__).resolve().parents[1]


def _well2proto():
    sys.path.insert(0, str(ROOT / "tools"))
    import well2proto

    return well2proto


def test_fem_system_equals_the_harness_matrix():
    import bench

    ref = bench.unstructured_fem_system(64)
    got = unstructured_fem_system(64)
    assert got.shape == ref.shape == (4096, 4096)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_plain_full_matches_the_jax_well_kernels(variant):
    import jax.numpy as jnp

    w2 = _well2proto()
    csr = unstructured_fem_system(40)
    n = csr.nrows
    b = w2.build_v2(csr.indptr, csr.indices, csr.data, n, n, F=4)
    x = np.random.default_rng(0).normal(size=n)
    n2d = b["x2d_rows"]
    x2d = jnp.asarray(np.pad(x, (0, n2d * w2.LANES - n)).reshape(n2d, w2.LANES),
                      jnp.float32)
    call = w2.v3_call if variant == "v3" else w2.v2_call
    out = call(b, interpret=True)(x2d)
    # well2proto.py:592-595's unpacking
    y_jax = np.asarray(out).reshape(-1, w2.BLOCKS_PER_VROW)[:, :b["g"]]
    y_jax = y_jax.reshape(-1)[:n].astype(np.float64)
    if len(b["extra_rows"]):
        np.add.at(y_jax, b["extra_rows"], b["extra_vals"] * x[b["extra_cols"]])
    mat = spmv.CappedCSR.from_csr(csr, "cpu", torch.float32)
    assert mat.n_tail == 0
    y = spmv_stages.csr_spmv_stages(
        mat, torch.from_numpy(x).float(), "full").double().numpy()
    scale = np.abs(y_jax).max()
    assert np.abs(y - y_jax).max() / scale <= 1e-6


def _random_csr(seed=0, n=300, m=307):
    """Rows of 0-90 entries (with cap 64 some spill to the tail)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 91, n)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, len(rows))
    return CSR.from_coo(rows, cols, rng.standard_normal(len(rows)), (n, m))


def _numpy_mode(csr, cap, x, mode, zero):
    """The modes' definitions over the first ``cap`` entries of each row:
    y (n,) for the reducing modes, the terms P in capped-CSR order for
    the ``nored`` modes."""
    n = csr.nrows
    y = np.zeros(n)
    terms = []
    for r in range(n):
        start = csr.indptr[r]
        end = min(csr.indptr[r + 1], start + cap)
        for j in range(start, end):
            v, c = csr.data[j], float(csr.indices[j])
            term = {
                "full": v * x[int(c)], "nored": v * x[int(c)],
                "rowgroup": v * x[int(c)], "dataonly": v,
            }.get(mode, v + zero * c)
            terms.append(term)
            y[r] += term
        if mode == "nogather":
            y[r] *= x[r]
    return np.array(terms) if mode in ("nored", "nogather_nored") else y


@pytest.mark.parametrize("mode", spmv_stages.MODES)
@pytest.mark.parametrize("zero", [0.0, 0.5])
def test_plain_modes_match_their_definitions(mode, zero):
    a = _random_csr()  # rectangular, 300 x 307
    mat = spmv.CappedCSR.from_csr(a, "cpu", torch.float64)
    assert mat.n_tail > 0
    x = np.random.default_rng(1).standard_normal(a.shape[1])
    got = spmv_stages.csr_spmv_stages(mat, torch.from_numpy(x), mode, zero)
    assert tuple(got.shape) == spmv_stages.out_shape(mat, mode)
    ref = _numpy_mode(a, mat.cap, x, mode, zero)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nored_partials_sum_to_full(dtype):
    csr = unstructured_fem_system(24)
    mat = spmv.CappedCSR.from_csr(csr, "cpu", dtype)
    x = wellablate.make_x(csr.nrows, "cpu", dtype)
    full = spmv_stages.csr_spmv_stages(mat, x, "full")
    parts = spmv_stages.csr_spmv_stages(mat, x, "nored")
    assert parts.shape == (mat.data.numel(),)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    sums = torch.zeros_like(full).index_add_(0, mat.rows(), parts)
    torch.testing.assert_close(sums, full, rtol=tol, atol=tol)
    # full is K1's function on the capped part
    torch.testing.assert_close(full, spmv.csr_spmv_capped(mat, x),
                               rtol=tol, atol=tol)


def test_stage_bytes_of_the_fem_matrix():
    # values + indices + the int32 block table (rows, first entries) +
    # int64 row pointers (none where no row is reduced) + x + output,
    # each once
    csr = unstructured_fem_system(16)
    mat = spmv.CappedCSR.from_csr(csr, "cpu", torch.float32)
    n, nnz, bounds = csr.nrows, csr.nnz, mat.n_blocks + 1
    # 256 rows, 1,792 entries: eight blocks of <= 256
    assert spmv.BLOCK_ENTRIES == 256 and bounds == 9
    rows = 8 * bounds + 8 * (n + 1)
    assert spmv_stages.stage_bytes(mat, "full") == 8 * nnz + rows + 8 * n
    assert spmv_stages.stage_bytes(mat, "nogather") == 8 * nnz + rows + 8 * n
    assert (spmv_stages.stage_bytes(mat, "streamonly")
            == 8 * nnz + rows + 4 * n)
    assert spmv_stages.stage_bytes(mat, "dataonly") == 4 * nnz + rows + 4 * n
    assert (spmv_stages.stage_bytes(mat, "nored")
            == 8 * nnz + 8 * bounds + 4 * n + 4 * nnz)
    assert (spmv_stages.stage_bytes(mat, "nogather_nored")
            == 8 * nnz + 8 * bounds + 4 * nnz)
    assert (spmv_stages.stage_bytes(mat, "rowgroup")
            == 8 * nnz + 8 * (n + 1) + 8 * n)


def test_rejects_bad_input():
    mat = spmv.CappedCSR.from_csr(_random_csr(m=280), "cpu", torch.float64)
    x = torch.zeros(mat.shape[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="mode"):
        spmv_stages.csr_spmv_stages(mat, x, "noA")
    with pytest.raises(ValueError):
        spmv_stages.csr_spmv_stages(mat, x.float(), "full")
    with pytest.raises(ValueError):
        spmv_stages.csr_spmv_stages(mat, x[:-1], "full")
    with pytest.raises(ValueError):  # more rows than columns
        spmv_stages.csr_spmv_stages(mat, x, "nogather")
    meta = spmv.CappedCSR.from_csr(_random_csr(), "meta", torch.float64)
    with pytest.raises(RuntimeError, match="no kernel"):
        spmv_stages.csr_spmv_stages(
            meta, torch.zeros(meta.shape[1], dtype=torch.float64,
                              device="meta"), "full")


def test_plain_version_does_not_count_launches():
    before = spmv_stages.stages_launches
    mat = spmv.CappedCSR.from_csr(_random_csr(), "cpu", torch.float64)
    spmv_stages.csr_spmv_stages(
        mat, torch.ones(mat.shape[1], dtype=torch.float64), "full")
    assert spmv_stages.stages_launches == before


def test_cli_on_cpu(capsys):
    records, mat, x = wellablate.run(["--device", "cpu", "--side", "16",
                                      "--reps", "1", "full", "dataonly"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "plain version" in lines[0] and "n=256" in lines[0]
    assert [r["mode"] for r in records] == ["full", "dataonly"]
    assert len(lines) == 3 and all("GB/s" in line for line in lines[1:])
    assert x.dtype == torch.float32 and mat.shape == (256, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_rowgroup_lanes():
    # the power of two nearest the mean capped row length, within [2, 32]
    for deg, lanes in ((1, 2), (3, 4), (7, 8), (16, 16), (23, 32), (64, 32)):
        indptr = np.arange(0, 10 * deg + 1, deg)
        csr = CSR(indptr=indptr, indices=np.arange(10 * deg) % 10,
                  data=np.ones(10 * deg), shape=(10, 10))
        mat = spmv.CappedCSR.from_csr(csr, "cpu", torch.float64)
        assert spmv_stages.rowgroup_lanes(mat) == lanes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(cuda, dtype):
    csr = unstructured_fem_system(64)
    mat = spmv.CappedCSR.from_csr(csr, cuda, dtype)
    x = wellablate.make_x(csr.nrows, cuda, dtype)
    before = spmv_stages.stages_launches
    full = spmv_stages.csr_spmv_stages(mat, x, "full")
    assert torch.equal(full, spmv.csr_spmv_capped(mat, x))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for mode in spmv_stages.MODES:
        got = spmv_stages.csr_spmv_stages(mat, x, mode)
        ref = spmv_stages.plain_csr_spmv_stages(mat, x, mode)
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert spmv_stages.stages_launches == before + 1 + len(spmv_stages.MODES)
