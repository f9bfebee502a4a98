"""The test harness, the problem generators, the geometric multigrid, the
model families, the two CLIs (the adaptive composite's peel study
included) and the rand-SVD test, against the JAX package.

The harness runs on a hierarchy built by tpu_amg and loaded by the port
from the checkpoint arrays; random draws are the reference's own
(``jax.random``), handed to the port as numpy.  Float64 on the CPU.  The
port's CLI draws from a ``torch.Generator``, so its iteration counts are
held within twice the JAX CLI's on the same arguments.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cycle import reference_lambda_starts
from tpu_amg import models as jax_models
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.utils import problems as jax_problems
from tpu_amg.utils import testing as jax_testing
from tpu_amg.utils.checkpoint import _pack_hierarchy
from tpu_amg_torch import models
from tpu_amg_torch.linop import DenseOperator, SparseOperator
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.tools import amg as amg_cli
from tpu_amg_torch.tools import rand_svd_test, simple_geometric
from tpu_amg_torch.utils import problems, testing
from tpu_amg_torch.utils.checkpoint import hierarchy_from_arrays

RTOL = 1e-10
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    """(JAX operator, JAX V-cycle, port operator, port V-cycle) from one
    hierarchy: poisson2d(24), block smoother (the CLI's default)."""
    a = jax_problems.poisson2d(24)
    rng = np.random.default_rng(0)
    nn, _ = np.linalg.qr(np.concatenate(
        [np.ones((a.nrows, 1)), rng.standard_normal((a.nrows, 3))], 1))
    ref_h = JaxHierarchyConfig(
        coarsest_dim=30,
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation",
            aggregation=JaxAggregationConfig(
                candidate_dimension=2,
                partitioner_config=JaxPartitionerConfig(coarsening_factor=8.0),
            ),
        ),
    ).build(a, nn)
    arrays = {}
    meta = _pack_hierarchy(ref_h, arrays)
    h = hierarchy_from_arrays(arrays, json.loads(json.dumps(meta)))
    kw = dict(smoother="block", dense_threshold=64, smoothing_steps=2)
    jax_cfg = JaxMultigridConfig(**kw)
    ref_mg = jax_cfg.build(ref_h)
    mg = MultigridConfig(device="cpu", **kw).build(
        h, lambda_starts=reference_lambda_starts(jax_cfg, ref_h))
    return (jax_aslinearoperator(ref_h.matrices[0]), ref_mg,
            SparseOperator.from_csr(h.matrices[0], "cpu"), mg)


@pytest.mark.parametrize("run_sli", [True, False])
def test_solver_report_matches_jax(pair, run_sli):
    ref_a, ref_mg, a, mg = pair
    rng = np.random.default_rng(1)
    b, x0 = rng.standard_normal((2, a.shape[0]))
    ref = jax_testing.test_solver(ref_a, ref_mg, jnp.asarray(b),
                                  jnp.asarray(x0), rtol=1e-8, maxiter=300,
                                  run_sli=run_sli)
    got = testing.test_solver(a, mg, torch.from_numpy(b),
                              torch.from_numpy(x0), rtol=1e-8, maxiter=300,
                              run_sli=run_sli)
    assert (got.cg_iters, got.cg_converged, got.sli_iters,
            got.sli_converged) == (ref.cg_iters, ref.cg_converged,
                                   ref.sli_iters, ref.sli_converged)
    assert got.cg_converged and got.sli_converged == run_sli
    # histories of recomputed residuals: 1e-10 relative to the first
    for mine, theirs in ((got.cg_history, ref.cg_history),
                         (got.sli_history, ref.sli_history)):
        np.testing.assert_allclose(mine, theirs, rtol=RTOL,
                                   atol=RTOL * theirs[0])
    assert got.reduction_factor() == pytest.approx(ref.reduction_factor(),
                                                   rel=RTOL)


def test_convergence_factor_matches_jax(pair):
    ref_a, ref_mg, a, mg = pair
    key = jax.random.PRNGKey(42)
    want = jax_testing.approx_convergence_factor(ref_a, ref_mg, key,
                                                 num_iters=30)
    starts = np.asarray(jax.random.normal(key, (a.shape[0], 5), jnp.float64))
    got = testing.approx_convergence_factor(a, mg, num_iters=30,
                                            starts=starts)
    assert 0.0 < got < 1.0
    assert got == pytest.approx(want, rel=RTOL)
    # its own draws: another start, the same operator's factor
    assert testing.approx_convergence_factor(a, mg, num_iters=30) == (
        pytest.approx(want, rel=0.2))


def test_symmetry_matches_jax(pair):
    ref_a, ref_mg, a, mg = pair
    key = jax.random.PRNGKey(0)
    n = a.shape[0]
    starts = []
    for i in range(5):  # the reference's draws (utils/testing.py:110-114)
        ku, kv = jax.random.split(jax.random.fold_in(key, i))
        starts.append(tuple(np.asarray(jax.random.normal(k, (n,),
                                                         jnp.float64))
                            for k in (ku, kv)))
    assert jax_testing.symmetry_test(ref_mg, key)
    assert testing.symmetry_test(mg, starts=starts, device="cpu")
    assert testing.symmetry_test(mg, device="cpu")
    skew = np.random.default_rng(2).standard_normal((n, n))
    assert not testing.symmetry_test(DenseOperator(torch.from_numpy(skew)),
                                     device="cpu")
    assert not jax_testing.symmetry_test(jax_aslinearoperator(skew), key)


@pytest.mark.parametrize("coefficient",
                         ["constant", "random", "layers", "checkerboard"])
def test_anisotropic_diffusion_matches_jax(coefficient):
    kw = dict(epsilon=1e-3, theta=np.pi / 6, coefficient=coefficient)
    got = problems.anisotropic_diffusion_2d(12, **kw)
    want = jax_problems.anisotropic_diffusion_2d(12, **kw)
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("name,args", [
    ("unstructured_poisson_2d", (9,)),
    ("geometric_interpolation_1d", (5,)),
    ("geometric_restriction_1d", (5,)),
])
def test_generators_match_jax(name, args):
    got = getattr(problems, name)(*args)
    want = getattr(jax_problems, name)(*args)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def test_simple_geometric_table_matches_jax():
    from tpu_amg.preconditioners import build_smoother
    from tpu_amg.solvers import cg, stationary_iteration
    from tpu_amg.utils.geometric import build_geometric_mg

    want = []
    for r in range(2, 7):  # examples/simple_geometric.py:37-56
        fine, mg = build_geometric_mg(r)
        a = jax_aslinearoperator(fine)
        b = jnp.ones(fine.nrows)
        jac = build_smoother("jacobi", a.ell, omega=0.66)
        want.append((r, fine.nrows,
                     int(cg(a, b, jac, rtol=1e-8, maxiter=20000)[1].iters),
                     int(cg(a, b, mg, rtol=1e-8, maxiter=1000)[1].iters),
                     int(stationary_iteration(a, b, mg, rtol=1e-8,
                                              maxiter=1000)[1].iters)))
    got = simple_geometric.main(["--device", "cpu", "--max-refine", "6"])
    assert got == want


def test_families_match_jax(tmp_path):
    for name, args in (("poisson", (6, 2)), ("poisson", (4, 3)),
                       ("anisotropic_diffusion", (6,)), ("elasticity", (3,))):
        got = getattr(models, name)(*args, device="cpu")
        want = getattr(jax_models, name)(*args)
        assert got.name == want.name
        assert got.matrix.block_size == want.matrix.block_size
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got.matrix, part),
                                          getattr(want.matrix, part))
        np.testing.assert_array_equal(got.matrix.to_dense(),
                                      want.matrix.to_dense())
        np.testing.assert_array_equal(got.rhs, want.rhs)
        for field in dataclasses.fields(got.solver_config):
            # torch dtypes and the device: the port's own (the JAX
            # package picks its bootstrap dtype by platform)
            if field.name not in ("dtype", "device", "bootstrap_dtype"):
                assert (getattr(got.solver_config, field.name)
                        == getattr(want.solver_config, field.name))
    mp = models.poisson(8, device="cpu")
    x, info = mp.setup_solver().solve(mp.rhs, rtol=1e-8)
    assert info.converged
    np.testing.assert_allclose(mp.matrix.matvec(x.numpy()), mp.rhs,
                               atol=1e-6)
    subprocess.run([sys.executable, "-m", "tpu_amg_torch.tools.make_fem_fixture",
                    "--side", "10", "--out", str(tmp_path / "fem")],
                   cwd=ROOT, check=True, capture_output=True)
    fem = models.from_mfem(tmp_path / "fem", "fem", device="cpu",
                           coarsest_dim=20)
    assert fem.solver_config.coarsest_dim == 20
    assert fem.coords.shape == (fem.matrix.nrows, 2)


# ---- the CLIs: the port's in this process, the JAX package's alone

CLI_CASES = {
    "sa": ["--n", "16", "--coarsest-dim", "40", "--coarsening-near-null-dim",
           "16", "--smoothing-iters", "10"],
    "structured": ["--structured", "--problem", "poisson3d", "--n", "12"],
    # block size 3, on two levels: the preset's cd 12 / 6 and coarsest 40
    # (at the defaults n=4 is one dense level, ||E||_A = 0)
    "elasticity3d": ["--problem", "elasticity3d", "--n", "4",
                     "--coarsest-dim", "40", "--coarsening-near-null-dim",
                     "12", "--interp-near-null-dim", "6",
                     "--smoothing-iters", "10"],
}


def _final_line(text):
    cg_iters, sli_iters, a_norm, oc = text.strip().splitlines()[-1].split()
    return int(cg_iters), int(sli_iters), float(a_norm), float(oc)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_amg_cli_matches_jax(case, capsys):
    args = CLI_CASES[case]
    ref = subprocess.run(
        [sys.executable, "examples/amg.py", *args], cwd=ROOT, check=True,
        capture_output=True, text=True,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(Path.home())},
    )
    want = _final_line(ref.stdout)
    amg_cli.main(["--device", "cpu", *args])
    out = capsys.readouterr()
    got = _final_line(out.out)
    assert "system: n=" in out.err and "setup: " in out.err
    assert ("structured setup: " in out.err) == (case == "structured")
    assert 0 < got[0] <= 2 * want[0] and 0 < got[1] <= 2 * want[1]
    assert 0.0 < got[2] < 1.0
    if case == "structured":
        assert np.isnan(got[3]) and np.isnan(want[3])
    else:
        assert "Hierarchy(levels=" in out.err and "nnz/row" in out.err
        assert got[3] == pytest.approx(want[3], rel=0.2)


CLASSICAL_CASES = {
    # the README's CPU run: a W-cycle by default
    "classical": ["--problem", "poisson2d", "--interpolation", "classical",
                  "--n", "32", "--smoother", "chebyshev"],
    # MEASURED.md:582's options, on two levels
    "opts": ["--interpolation", "classical", "--classical-opts",
             "tau=1.3,max=2", "--n", "16", "--coarsest-dim", "100"],
    "mu": ["--interpolation", "classical", "--n", "16", "--coarsest-dim",
           "100", "--mu", "1", "--classical-opts",
           "search=2,depth=1,cands=8,cr_target=0.4,relax=4"],
}


@pytest.mark.parametrize("case", list(CLASSICAL_CASES))
def test_amg_cli_classical(case, capsys):
    """--interpolation classical and --classical-opts run: the final
    line parses, PCG converges and ||E||_A is in (0, 1) on a classical
    hierarchy of two or more levels."""
    amg_cli.main(["--device", "cpu", "--tol", "1e-8",
                  *CLASSICAL_CASES[case]])
    out = capsys.readouterr()
    cg_iters, sli_iters, a_norm, oc = _final_line(out.out)
    assert "Hierarchy(levels=" in out.err and "cg_converged=True" in out.err
    assert "Hierarchy(levels=1" not in out.err
    assert 0 < cg_iters <= 30 and 0.0 < a_norm < 1.0 and oc > 1.0


def test_amg_cli_classical_config():
    """The classical options reach the config; --mu overrides the auto
    choice; an unknown key exits."""
    args = amg_cli.parse_args(["--device", "cpu", "--interpolation",
                               "classical", "--classical-opts",
                               "tau=1.3,max=2,cands=8,relax=4", "--mu", "1"])
    hier_cfg, mg_cfg = amg_cli.configs(args)
    interp = hier_cfg.interpolation_config
    assert interp.kind == "classical" and mg_cfg.mu == 1
    ls, cr = interp.classical.ls_options, interp.classical.cr_options
    assert (ls.tau_threshold, ls.max_interp, ls.max_candidates,
            cr.relax_steps) == (1.3, 2, 8, 4)
    sa_cfg, _ = amg_cli.configs(amg_cli.parse_args(["--device", "cpu"]))
    assert sa_cfg.interpolation_config.kind == "aggregation"
    assert amg_cli.solver_config(args).method == "classical"
    with pytest.raises(SystemExit, match="unknown classical opt 'bogus'"):
        amg_cli.main(["--device", "cpu", "--n", "8", "--classical-opts",
                      "bogus=1"])


PRECISION_PATHS = {
    "structured": ["--structured", "--problem", "poisson3d", "--n", "16"],
    "sa": ["--n", "16", "--coarsest-dim", "40", "--coarsening-near-null-dim",
           "16", "--smoothing-iters", "10"],
}


@pytest.mark.parametrize("mode", ["bf16_values", "f32"])
@pytest.mark.parametrize("path", list(PRECISION_PATHS))
def test_amg_cli_precision(path, mode, capsys):
    """--precision casts the built cycle (the outer PCG stays f64): the
    final line parses and PCG converges, within 3 iterations of the f64
    cycle's count on the same arguments."""
    args = ["--device", "cpu", "--tol", "1e-10", "--max-iters", "200",
            *PRECISION_PATHS[path]]
    amg_cli.main([*args, "--precision", mode, "--skip-enorm"])
    out = capsys.readouterr()
    cg_iters, sli_iters, _, _ = _final_line(out.out)
    assert "cg_converged=True" in out.err
    amg_cli.main([*args, "--skip-enorm"])
    f64_iters = _final_line(capsys.readouterr().out)[0]
    assert 0 < cg_iters <= f64_iters + 3 and 0 < sli_iters <= 200


COMPOSITE_ARGS = ["--n", "12", "--coarsest-dim", "30",
                  "--coarsening-near-null-dim", "4", "--smoothing-iters", "10",
                  "--composite", "2"]


def _table(text, title):
    """The rows of one peel table: (components, iterations, v-cycles,
    final rel residual)."""
    lines = text[text.index(title):].splitlines()[4:]
    rows = []
    for line in lines:
        if not line.startswith("|"):
            break
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows.append((int(cells[0]), int(cells[1]), int(cells[2]),
                     float(cells[5])))
    return rows


def test_amg_cli_composite_peel(capsys):
    """--composite 2: the peel study's two tables (2, then 1 component),
    then the final line; PCG converges, and with both components in
    no more iterations than with the first alone."""
    amg_cli.main(["--device", "cpu", *COMPOSITE_ARGS])
    out = capsys.readouterr()
    pcg = _table(out.out, "Composite PCG results:")
    sli = _table(out.out, "Composite stationary results:")
    assert [r[0] for r in pcg] == [r[0] for r in sli] == [2, 1]
    for count, iters, vcycles, _ in pcg + sli:
        assert vcycles == iters * (2 * count - 1)
    assert pcg[0][3] <= 1e-12 and pcg[1][3] <= 1e-12  # converged
    assert 0 < pcg[0][1] <= pcg[1][1]
    cg_iters, sli_iters, a_norm, oc = _final_line(out.out)
    assert cg_iters == pcg[0][1] and 0 < sli_iters < 1000
    assert 0.0 < a_norm < 1.0 and np.isnan(oc)
    assert "setup: " in out.err


def test_rand_svd_test_scores():
    r = rand_svd_test.run("cpu")
    assert r["score"] >= 0.99
    assert min(r["align_u"], r["align_v"]) > 0.99
