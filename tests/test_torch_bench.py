"""The SpMV throughput benchmark (``tpu_amg_torch.tools.bench``) against
the JAX package's ``bench.py`` on the CPU, at small sizes.

The f32 DIA of ``poisson3d(12)`` has the JAX ``try_from_csr``'s offsets
and data, and its bf16 cast the JAX cast's bits.  On a numpy-seeded x
the structured formats (``"dia"``, ``"csr"``, ``"ell"``) and the
bf16-value DIA agree with the JAX DIA apply, and the FEM system's K1 +
K2 applies at (f32, f32) and (bf16, f32) with the JAX package's ELL
apply (the JAX package runs no WELL on the CPU), to 1e-6 of the largest
entry: the plain versions sum in another order than the JAX package's,
in f32.  :func:`summary` equals ``bench.py``'s formulas, written out
below with their lines.  The command line runs on the CPU and prints
the eight keys last; ``--device cuda`` raises without a card.  JAX is
imported inside the tests that use it, so the card's test, which holds
every kernel against its plain version, runs where JAX is absent.
"""

import json
import math

import numpy as np
import pytest
import torch

from tpu_amg_torch.tools import bench
from tpu_amg_torch.utils.problems import poisson3d, unstructured_fem_system

GRID, SIDE = 12, 32
RTOL = 1e-6  # f32, another summation order


@pytest.fixture(scope="module")
def port():
    """The timed matrices of the port on the CPU, by APPLIES name."""
    return bench.matrices(poisson3d(GRID), unstructured_fem_system(SIDE),
                          torch.device("cpu"))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's f32 DIA of poisson3d(GRID) and ELL of
    bench.unstructured_fem_system(SIDE), by the port's APPLIES name."""
    import jax.numpy as jnp

    import bench as jax_bench
    from tpu_amg.sparse import ELL
    from tpu_amg.sparse.csr import CSR
    from tpu_amg.sparse.dia import try_from_csr
    from tpu_amg.utils.problems import poisson3d as jax_poisson3d

    dia = try_from_csr(jax_poisson3d(GRID), dtype=jnp.float32)
    ell = ELL.from_csr(CSR.from_scipy(jax_bench.unstructured_fem_system(SIDE)),
                       dtype=jnp.float32)
    return dict(dia=dia, csr=dia, ell=dia, dia_bf16v=dia.astype(jnp.bfloat16),
                fem=ell, fem_bf16v=ell.astype(jnp.bfloat16))


def _x(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_dia_matches_jax(port, ref):
    got, want = port["dia"], ref["dia"]
    assert got.offsets == want.offsets
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    got16 = port["dia_bf16v"].data
    want16 = np.asarray(ref["dia_bf16v"].data)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.view(torch.int16).numpy(),
                                  want16.view(np.int16))


def test_fem_bf16_values_match_jax(port, ref):
    """The FEM system's bf16 values, bit for bit, slot by slot (both
    keep each row's entries in CSR order)."""
    got = port["fem_bf16v"]
    want = ref["fem_bf16v"]
    keep = np.arange(want.data.shape[1])[None, :] < np.diff(
        got.indptr.numpy())[:, None]
    np.testing.assert_array_equal(
        got.data.view(torch.int16).numpy(),
        np.asarray(want.data).view(np.int16)[keep])
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.cols)[keep])


@pytest.mark.parametrize("name", bench.APPLIES)
def test_applies_match_jax(port, ref, name):
    import jax.numpy as jnp

    mat = port[name]
    x = _x(mat.shape[1])
    got = bench.apply(mat, torch.from_numpy(x))
    want = np.asarray(ref[name].mv(jnp.asarray(x)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _bench_py_line(nnz, n, dt_dia, dt_dia16, bw, ap_nnz, ap_n, dt_un,
                   dt_un16):
    """bench.py's arithmetic as it stands there, on its names."""
    nnz_per_s = nnz / dt_dia                              # bench.py:196-198
    bytes_min = 4 * nnz + 4 * n + 4 * n                   # bench.py:202
    roofline_nnz_s = nnz * bw / bytes_min                 # bench.py:204
    target = 0.70 * roofline_nnz_s                        # bench.py:205
    un_roofline = ap_nnz * bw / (4 * ap_nnz + 8 * ap_n)   # bench.py:238
    un = {                                                # bench.py:239-245
        "unstructured_gnnzs": round(ap_nnz / dt_un / 1e9, 4),
        "unstructured_bf16v_gnnzs": round(ap_nnz / dt_un16 / 1e9, 4),
        "unstructured_vs_target": round(
            (ap_nnz / dt_un) / (0.70 * un_roofline), 4),
    }
    extra = {"bf16_values_gnnzs": round(nnz / dt_dia16 / 1e9, 4)}  # :255-256
    return {                                              # bench.py:257-267
        "metric": "spmv_throughput_3d_poisson_1M",
        "value": round(nnz_per_s / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(nnz_per_s / target, 4),
        **extra,
        **un,
    }


@pytest.mark.parametrize("case", [
    # poisson3d(100) and unstructured_fem_system(1024) at PERF.md's times
    (6_940_000, 1_000_000, 14.14e-6, 6.44e-6, 3.0234e12, 7_339_948,
     1_048_576, 33.55e-6, 25.0e-6),
    (11_232, 1_728, 2.5e-4, 3.1e-4, 2.9e11, 7_124, 1_024, 1.6e-4, 1.7e-4),
])
def test_summary_is_bench_pys_arithmetic(case):
    nnz, n, dt, dt16, bw, fnnz, fn, dtu, dtu16 = case
    got = bench.summary(nnz=nnz, n=n, seconds=dt, bf16_seconds=dt16,
                        bandwidth=bw, fem_nnz=fnnz, fem_n=fn, fem_seconds=dtu,
                        fem_bf16_seconds=dtu16)
    want = _bench_py_line(nnz, n, dt, dt16, bw, fnnz, fn, dtu, dtu16)
    assert got == want
    assert list(got) == list(want) == list(bench.KEYS)


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's plain gathers and index_add_ then
    time without the jitter of threads contending with other processes,
    and the rounded ratios stay above 0."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_cli_on_cpu(capsys, one_thread):
    res = bench.run(["--device", "cpu", "--grid", str(GRID), "--side",
                     str(SIDE), "--reps", "2"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == res["json"]
    assert list(line) == list(bench.KEYS)
    assert line["metric"] == bench.METRIC and line["unit"] == "Gnnz/s"
    nums = [line[k] for k in bench.KEYS if k not in ("metric", "unit")]
    assert all(math.isfinite(v) and v > 0 for v in nums), line
    rec = res["record"]
    assert rec["fmt"] in bench.FORMATS
    assert rec["poisson"] == dict(n=GRID ** 3, nnz=poisson3d(GRID).nnz,
                                  tail_rows=0)
    assert rec["fem"]["n"] == SIDE ** 2 and rec["fem"]["tail_rows"] == 0
    assert set(rec["applies"]) == set(bench.APPLIES)
    # the bytes a call: K3's diagonals + x + y; the ELL's capped CSR is
    # the CSR's own, so K1 moves the same bytes through both
    n = GRID ** 3
    assert rec["applies"]["dia"]["bytes"] == 7 * n * 4 + 8 * n
    assert rec["applies"]["dia_bf16v"]["bytes"] == 7 * n * 2 + 8 * n
    assert rec["applies"]["ell"]["bytes"] == rec["applies"]["csr"]["bytes"]
    assert "fmt=" in err and "K2 tail rows: poisson 0, fem 0" in err


def test_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(["--grid", str(GRID), "--side", str(SIDE)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_measure_on_card(cuda):
    from tpu_amg_torch.ops import dia as dia_ops
    from tpu_amg_torch.ops import spmv

    spmv.reset_launch_counts()
    dia_ops.reset_launch_counts()
    res = bench.measure(poisson3d(GRID), unstructured_fem_system(SIDE), cuda,
                        reps=2)
    torch.cuda.synchronize()
    assert dia_ops.dia_spmv_launches > 0 and spmv.csr_spmv_launches > 0
    assert spmv.coo_patch_launches == 0
    assert all(math.isfinite(v) and v > 0 for k, v in res["json"].items()
               if k not in ("metric", "unit"))
    for name, mat in res["matrices"].items():
        for x in (torch.ones(mat.shape[1], device=cuda),
                  torch.from_numpy(_x(mat.shape[1])).to(cuda)):
            got, want = bench.apply(mat, x), bench.plain_apply(mat, x)
            torch.cuda.synchronize()
            scale = max(float(want.abs().max()), 1e-30)
            assert float((got - want).abs().max()) <= 1e-5 * scale, name
