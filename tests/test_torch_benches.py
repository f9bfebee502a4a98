"""The V-cycle benches, the V-cycle breakdown, ``ComposedOperator`` and
the top-level names, against the JAX package.

``bench_vcycle``'s float32 multigrid at 24³ (the JAX tool's CPU grid)
is held against the JAX package's, built from the same λ_max start
vectors: one cycle agrees to 1e-5 (relative to its largest entry;
float32), and the PCG solve of A x = 1 to rtol 1e-6 takes the same
iterations.  ``bench_unstructured`` prints the JAX tool's JSON keys (at
side 48: side 32's 1,024 rows are under the config's coarsest 1500, a
one-level cycle).  The breakdown's sum of components is checked against
a count of the applies one cycle makes.  Float64 elsewhere, on the CPU.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_amg
import tpu_amg.utils
import tpu_amg_torch
import tpu_amg_torch.utils
from tpu_amg.linop import ComposedOperator as JaxComposedOperator
from tpu_amg.linop import DenseOperator as JaxDenseOperator
from tpu_amg.linop import SparseOperator as JaxSparseOperator
from tpu_amg.solver import SolverConfig as JaxSolverConfig
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.structured import build_structured_multigrid as jax_build
from tpu_amg.utils import problems as jax_problems
from tpu_amg_torch.linop import ComposedOperator, DenseOperator
from tpu_amg_torch.preconditioners.composite import Composite
from tpu_amg_torch.solver import AMGSolver, scalar_3d_config
from tpu_amg_torch.solver import unstructured_config
from tpu_amg_torch.tools import bench_unstructured, bench_vcycle
from tpu_amg_torch.tools import vcycle_breakdown
from tpu_amg_torch.utils.problems import unstructured_poisson_3d
from tpu_amg_torch.utils.timing import solve_best

CYCLE_RTOL = 1e-5  # float32
COMPOSE_RTOL = 1e-12
GRID = 24


# ---- ComposedOperator and the top-level names


def test_composed_operator_matches_jax():
    rng = np.random.default_rng(0)
    ma, mb = rng.standard_normal((7, 5)), rng.standard_normal((4, 7))
    got = ComposedOperator(a=DenseOperator(mat=torch.from_numpy(ma)),
                           b=DenseOperator(mat=torch.from_numpy(mb)))
    ref = JaxComposedOperator(a=JaxDenseOperator(mat=jnp.asarray(ma)),
                              b=JaxDenseOperator(mat=jnp.asarray(mb)))
    assert got.shape == ref.shape == (4, 5)
    for method, n in (("mv", (5,)), ("mm", (5, 3)), ("rmv", (4,)),
                      ("rmm", (4, 2))):
        x = rng.standard_normal(n)
        np.testing.assert_allclose(
            getattr(got, method)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(ref, method)(jnp.asarray(x))),
            rtol=COMPOSE_RTOL, atol=COMPOSE_RTOL)
    np.testing.assert_allclose(got(torch.from_numpy(np.ones(5))).numpy(),
                               mb @ ma @ np.ones(5), rtol=COMPOSE_RTOL)


@pytest.mark.parametrize("pkg,ref", [(tpu_amg_torch, tpu_amg),
                                     (tpu_amg_torch.utils, tpu_amg.utils)])
def test_every_jax_name_resolves(pkg, ref):
    assert set(ref.__all__) <= set(pkg.__all__)
    for name in ref.__all__:
        got = getattr(pkg, name)
        assert got is not None
        if callable(got):
            assert got.__name__ == getattr(ref, name).__name__
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")


# ---- bench_vcycle


@pytest.fixture(scope="module")
def vcycle_pair():
    a = jax_problems.poisson3d(GRID)
    ref = jax_build(a, (GRID,) * 3, coarsest_dim=1500, dtype=jnp.float32)
    # the JAX package's λ_max start vectors (PRNGKey 7, float32 draws)
    starts = [np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (lvl.a.shape[0],), jnp.float32))
        for lvl in ref.levels]
    got_a, got = bench_vcycle.build(GRID, "cpu", lambda_starts=starts)
    return a, ref, got_a, got


def test_bench_vcycle_cycle_matches_jax(vcycle_pair):
    _, ref, _, got = vcycle_pair
    assert len(got.levels) == len(ref.levels)
    x = np.random.default_rng(1).standard_normal(GRID ** 3).astype(
        np.float32)
    y = got(torch.from_numpy(x)).numpy()
    y_ref = np.asarray(ref(jnp.asarray(x)))
    assert y.dtype == np.float32
    assert np.abs(y - y_ref).max() <= CYCLE_RTOL * np.abs(y_ref).max()


def test_bench_vcycle_pcg_iterations_match_jax(vcycle_pair):
    a, ref, got_a, got = vcycle_pair
    op = JaxSparseOperator.from_csr(a, dtype=jnp.float32, dia_max_diags=160,
                                    dia_max_density=8.0)
    _, ref_info = jax.jit(lambda b: jax_cg(op, b, ref, rtol=1e-6,
                                           maxiter=100))(
        jnp.ones(a.nrows, jnp.float32))
    rec = solve_best(
        bench_vcycle.pcg_solver(got_a, got, torch.device("cpu")),
        torch.ones(a.nrows, dtype=torch.float32), bench_vcycle.RTOL,
        bench_vcycle.MAXITER)
    assert rec["converged"] and bool(ref_info.converged)
    assert rec["iters"] == int(ref_info.iters)


def test_bench_vcycle_json(capsys):
    res = bench_vcycle.run(["--device", "cpu", "--grid", "12", "--reps",
                            "2"])
    lines = capsys.readouterr()
    out = json.loads(lines.out.strip().splitlines()[-1])
    assert out == res["json"]
    assert set(out) == {"metric", "value", "unit", "vs_baseline",
                        "value_bf16_values", "value_bf16"}
    assert out["metric"] == "vcycle_wall_time_3d_poisson_12cubed"
    assert res["solves"]["f32"]["converged"]
    assert res["solves"]["bf16_values"]["converged"]
    for tag in ("# vcycle[bf16_values]=", "# vcycle=", "sol=", "bw=",
                "# full PCG solve: ", "# full PCG solve[bf16_values cycle]"):
        assert tag in lines.err
    # the minimum traffic: 9 passes of each level's values and rows
    mg = res["multigrid"]
    want = sum(9 * (4 * (lvl.a.mat.nnz if hasattr(lvl.a.mat, "nnz")
                         else lvl.a.shape[0] ** 2) + 8 * lvl.a.shape[0])
               for lvl in mg.levels)
    assert bench_vcycle.sol_bytes(mg) == want > 0


# ---- bench_unstructured


def test_unstructured_config_is_the_jax_tools():
    # bench_unstructured.py:60-75 of the JAX package
    ref = JaxSolverConfig(coarsening_near_null_dim=8, interp_near_null_dim=2,
                          smoothing_steps=1, smoothing_iters=10,
                          coarsest_dim=1500, dtype=jnp.float32,
                          dense_threshold=8192)
    got = unstructured_config("cpu")
    assert got.dtype == torch.float32
    for f in dataclasses.fields(got):
        if f.name in ("dtype", "device", "bootstrap_dtype"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_bench_unstructured_json(tmp_path, capsys):
    ckpt = str(tmp_path / "u48.npz")
    argv = ["--device", "cpu", "--side", "48", "--reps", "2", "--ckpt", ckpt]
    res = bench_unstructured.run(argv)
    err = capsys.readouterr().err
    assert set(res["json"]) == {
        "metric", "setup_s", "value", "unit", "vs_baseline",
        "value_bf16_values", "solve_ms_f32", "solve_ms_bf16_values",
        "iters_f32", "iters_bf16_values"}
    assert res["json"]["metric"] == "unstructured_fem2d_vcycle_2304"
    assert res["solves"]["f32"]["converged"]
    assert res["solves"]["bf16_values"]["converged"]
    assert re.search(r"# level 0: n=2304 fmt=\w+", err)
    assert "op complexity" in err
    # a second run loads the checkpoint: the same hierarchy and counts
    again = bench_unstructured.run(argv)
    assert again["json"]["iters_f32"] == res["json"]["iters_f32"]
    assert again["op_complexity"] == res["op_complexity"]


# ---- vcycle_breakdown


class _Counted:
    """Counts the applies of the operator it wraps."""

    def __init__(self, op, counts, key):
        self.op, self.counts, self.key = op, counts, key
        self.shape = op.shape

    def __call__(self, x):
        self.counts[self.key] = self.counts.get(self.key, 0) + 1
        return self.op(x)


def _count_cycle(mg):
    """The applies of each operator in one cycle of ``mg``."""
    counts = {}
    levels = tuple(dataclasses.replace(
        lvl, a=_Counted(lvl.a, counts, (i, "a")),
        smoother=_Counted(lvl.smoother, counts, (i, "s")),
        p=_Counted(lvl.p, counts, (i, "p")),
        r=_Counted(lvl.r, counts, (i, "r"))) for i, lvl in enumerate(mg.levels))
    counted = dataclasses.replace(
        mg, levels=levels,
        coarse_solver=_Counted(mg.coarse_solver, counts, "coarse"))
    counted(torch.ones(mg.shape[0], dtype=torch.float64))
    return counts


@pytest.fixture(scope="module")
def small_solver():
    a = unstructured_poisson_3d(10)
    solver = AMGSolver.setup(a, scalar_3d_config(
        "cpu", coarsest_dim=30, coarsening_factor=8.0, smoothing_steps=2))
    assert solver.hierarchy.num_levels >= 3
    return a, solver


def test_breakdown_sum_is_the_cycles_count(small_solver):
    _, solver = small_solver
    mg = solver.preconditioner
    counts = _count_cycle(mg)
    steps = mg.smoothing_steps
    for i in range(len(mg.levels)):
        assert counts[(i, "a")] == 2 * steps + 1
        assert counts[(i, "s")] == 2 * steps
        assert counts[(i, "p")] == counts[(i, "r")] == 1
    assert counts["coarse"] == 1
    res = vcycle_breakdown.breakdown(mg, 2, say=lambda msg: None)
    assert res["steps"] == steps == 2
    by_hand = res["coarse"]["ms"] + sum(
        counts[(i, "a")] * lv["a_ms"] + counts[(i, "s")] * lv["smoother_ms"]
        + lv["p_ms"] + lv["r_ms"] for i, lv in enumerate(res["levels"]))
    assert res["sum_ms"] == pytest.approx(by_hand, rel=1e-12)
    assert res["full_ms"] > 0


def test_breakdown_composite(small_solver):
    a, solver = small_solver
    mg = solver.preconditioner
    comp = Composite(a=solver.op, components=(mg, mg))
    res = vcycle_breakdown.breakdown(comp, 2, say=lambda msg: None)
    assert res["runs"] == [1, 2]
    c = res["components"]
    assert res["sum_ms"] == pytest.approx(
        c[0]["sum_ms"] + 2 * c[1]["sum_ms"] + 2 * res["a_ms"], rel=1e-12)


def test_breakdown_cli_lines(small_solver, tmp_path, capsys):
    _, solver = small_solver
    ckpt = str(tmp_path / "h10.npz")
    solver.save(ckpt)
    vcycle_breakdown.main(["--device", "cpu", "--side", "10", "--ckpt", ckpt,
                           "--reps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    n_levels = solver.hierarchy.num_levels
    # the JAX tool's line formats (tools/vcycle_breakdown.py:131-151)
    level = re.compile(r"# level \d+ n=\d+ fmt=\w+: A\.mv +[\d.]+ms  "
                       r"smoother +[\d.]+ms  P +[\d.]+ms  R +[\d.]+ms")
    assert [bool(level.fullmatch(ln)) for ln in lines[:-2]] == [True] * (
        n_levels - 1)
    assert re.fullmatch(r"# coarse solve n=\d+: [\d.]+ms", lines[-2])
    assert re.fullmatch(r"# sum-of-components estimate [\d.]+ms vs full "
                        r"V-cycle [\d.]+ms", lines[-1])
