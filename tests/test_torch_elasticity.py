"""Block-3 elasticity and the float32 bootstrap against the JAX package.

- The generators: ``unstructured_elasticity_3d`` and ``elasticity_3d``
  give the JAX package's CSR bit for bit, block size 3.
- Block-3 SA: the fixture of ``tests/test_elasticity_e2e.py``
  (``elasticity_3d(5)``, 375 dofs) with the JAX package's own bootstrap
  draws handed to the port: the hierarchies agree to 1e-10 relative
  (block sizes 3 and 6) and PCG takes the same iterations, with the
  Chebyshev and with the block smoother (its vector-dof compensation).
  Then ``AMGSolver.setup`` on ``unstructured_elasticity_3d(8)`` with
  ``elasticity_3d_config`` cut to coarsest 200, dense 1000: the same
  levels, the same PCG iterations (12), the solution to 1e-8.
- The float32 bootstrap: the JAX package's ``_smooth_loop`` in float32
  on a float32 operator (the loop of its accelerator bootstrap,
  ``tpu_amg/adaptivity.py:246-281``) against the port's float32
  ``smooth_vector`` from the same start block, both phases (l1 and the
  block smoother on the JAX package's partition).  Tolerance: the
  spans' projectors and the convergence factors to 1e-5 (measured
  ~2e-8 and ~4e-7: float32 rounding, summed in another order).
- The tools on the CPU at a tiny size: ``tools.setup3d`` /
  ``tools.solve3d --elasticity`` and ``tools.bench_elasticity``.
- ``cuda``: K1 + K2 at the elasticity path's shapes (the fine A at ~47
  entries a row, the block-6 coarse A whose rows run past the cap) and
  at (f32, f32) k = 11, the elasticity bootstrap's block, against their
  plain versions.

Float64 on the CPU unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

try:  # the reference: absent where only the card's tests run
    import jax
    import jax.numpy as jnp

    from tests.test_torch_cycle import reference_lambda_starts
    from tpu_amg import adaptivity as jax_adaptivity
    from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
    from tpu_amg.hierarchy import create_weights as jax_create_weights
    from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
    from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
    from tpu_amg.linop import DiagonalOperator as JaxDiagonalOperator
    from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
    from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
    from tpu_amg.preconditioners.block_smoother import (
        BlockSmoother as JaxBlockSmoother,
    )
    from tpu_amg.preconditioners.multigrid_builder import (
        MultigridConfig as JaxMultigridConfig,
    )
    from tpu_amg.solver import AMGSolver as JaxSolver
    from tpu_amg.solver import SolverConfig as JaxConfig
    from tpu_amg.solvers import cg as jax_cg
    from tpu_amg.utils import problems as jax_problems
except ImportError:
    jax = None

from tpu_amg_torch.adaptivity import find_near_null, smooth_vector
from tpu_amg_torch.hierarchy import HierarchyConfig, create_weights
from tpu_amg_torch.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg_torch.linop import DiagonalOperator, SparseOperator
from tpu_amg_torch.partition import Partition, PartitionerConfig
from tpu_amg_torch.preconditioners.block_smoother import BlockSmoother
from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg_torch.solver import (
    AMGSolver,
    SolverConfig,
    elasticity_3d_config,
    setup_draws,
)
from tpu_amg_torch.solvers import cg
from tpu_amg_torch.utils import problems

RTOL = 1e-6
F32_TOL = 1e-5  # projector and factor differences of the f32 smoothing


def _need_jax():
    if jax is None:
        pytest.skip("the JAX package (the reference) is not installed")


# ---- the generators, bit for bit

GENERATORS = [
    ("unstructured_elasticity_3d", (4,), {"seed": 0}),
    ("unstructured_elasticity_3d", (4,), {"seed": 3}),
    ("unstructured_elasticity_3d", (8,), {"seed": 0}),
    ("unstructured_elasticity_3d", (8,), {"seed": 3}),
    ("elasticity_3d", (3,), {}),
    ("elasticity_3d", (4, 5, 3), {}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_match_jax(name, args, kw):
    _need_jax()
    got = getattr(problems, name)(*args, **kw)
    want = getattr(jax_problems, name)(*args, **kw)
    assert got.shape == want.shape and got.block_size == want.block_size == 3
    for field in ("indptr", "indices", "data"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---- block-3 SA: the JAX package's elasticity fixture

E2E_SIDE = 5


def _hierarchy_kwargs(jax_side: bool):
    part, interp, agg, hier = (
        (JaxPartitionerConfig, JaxInterpolationConfig, JaxAggregationConfig,
         JaxHierarchyConfig) if jax_side else
        (PartitionerConfig, InterpolationConfig, AggregationConfig,
         HierarchyConfig))
    extra = {} if jax_side else {"device": "cpu"}
    return hier(
        coarsest_dim=60,
        interpolation_config=interp(
            kind="aggregation",
            aggregation=agg(
                candidate_dimension=6,
                partitioner_config=part(coarsening_factor=4.0,
                                        max_improvement_iters=10),
            ),
        ),
        **extra,
    )


@pytest.fixture(scope="module")
def e2e_pair():
    """tests/test_elasticity_e2e.py's fixture in both packages, the port
    bootstrapping from the JAX package's draws."""
    _need_jax()
    a_ref = jax_problems.elasticity_3d(E2E_SIDE)
    key = jax.random.PRNGKey(0)
    nn_ref = jax_adaptivity.find_near_null(a_ref, 10, 5, 16.0, key)
    k1, k2 = jax.random.split(key)
    starts = tuple(np.asarray(jax.random.normal(k, (a_ref.nrows, 5),
                                                jnp.float64))
                   for k in (k1, k2))
    a = problems.elasticity_3d(E2E_SIDE)
    nn = find_near_null(a, 10, 5, 16.0, "cpu", starts=starts)

    def basis(v):
        q, _ = np.linalg.qr(np.concatenate([np.ones((len(v), 1)), v], axis=1))
        return q

    ref_h = _hierarchy_kwargs(True).build(a_ref, basis(nn_ref),
                                          jax_create_weights(a_ref,
                                                             basis(nn_ref)))
    h = _hierarchy_kwargs(False).build(a, basis(nn), create_weights(a,
                                                                    basis(nn)))
    return a_ref, ref_h, a, h, nn_ref, nn


def test_block3_bootstrap_matches_jax(e2e_pair):
    *_, nn_ref, nn = e2e_pair
    np.testing.assert_allclose(nn, nn_ref, rtol=0,
                               atol=1e-10 * np.abs(nn_ref).max())


def test_block3_hierarchy_matches_jax(e2e_pair):
    _, ref_h, _, h, _, _ = e2e_pair
    assert h.num_levels == ref_h.num_levels >= 2
    assert [m.block_size for m in h.matrices] == [
        m.block_size for m in ref_h.matrices]
    assert h.matrices[0].block_size == 3 and h.matrices[1].block_size == 6
    for kind in ("matrices", "interpolations", "restrictions"):
        for got, want in zip(getattr(h, kind), getattr(ref_h, kind)):
            assert got.shape == want.shape
            g, w = got.to_dense(), want.to_dense()
            assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()


@pytest.mark.parametrize("smoother", ["chebyshev", "block"])
def test_block3_pcg_matches_jax(e2e_pair, smoother):
    """The two tests of tests/test_elasticity_e2e.py: the Chebyshev
    cycle (one step) and the block smoother (two steps, its vector-dof
    SVD compensation at block size 3), PCG of A x = 1 to 1e-8."""
    a_ref, ref_h, a, h, _, _ = e2e_pair
    if smoother == "chebyshev":
        jcfg = JaxMultigridConfig(smoother="chebyshev", smoothing_steps=1)
        pcfg = MultigridConfig(smoother="chebyshev", smoothing_steps=1,
                               device="cpu")
    else:
        jcfg = JaxMultigridConfig(
            smoothing_steps=2, smoother_partitioner=JaxPartitionerConfig(
                coarsening_factor=8.0, max_improvement_iters=10))
        pcfg = MultigridConfig(
            smoothing_steps=2, device="cpu",
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=8.0, max_improvement_iters=10))
    assert jcfg.smoother == pcfg.smoother == smoother
    ref_mg = jcfg.build(ref_h)
    mg = pcfg.build(h, reference_lambda_starts(jcfg, ref_h))
    _, ref_info = jax_cg(jax_aslinearoperator(a_ref), jnp.ones(a_ref.nrows),
                         ref_mg, rtol=1e-8)
    _, info = cg(SparseOperator.from_csr(a, "cpu"),
                 torch.ones(a.nrows, dtype=torch.float64), mg, rtol=1e-8)
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters)
    np.testing.assert_allclose(info.history(), ref_info.history(),
                               rtol=1e-8)


# ---- AMGSolver.setup on the unstructured truss

SETUP_SIDE = 8
CUT = dict(coarsest_dim=200, dense_threshold=1000)


@pytest.fixture(scope="module")
def setup_pair():
    """The JAX package's SA setup and solve with setup3d's elasticity
    config (float64, cut to coarsest 200 and dense 1000), and the port's
    from the same draws."""
    _need_jax()
    a_ref = jax_problems.unstructured_elasticity_3d(SETUP_SIDE)
    cfg = elasticity_3d_config("cpu", **CUT)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "coarsening_near_null_dim", "interp_near_null_dim",
        "coarsening_factor", "smoothing_steps", "smoothing_iters",
        "coarsest_dim", "dense_threshold", "sa_trunc_tol",
        "coarse_drop_tol")})
    ref = JaxSolver.setup(a_ref, jcfg)
    b = a_ref.to_scipy() @ np.random.default_rng(5).standard_normal(
        a_ref.nrows)
    x_ref, ref_info = ref.solve(jnp.asarray(b), rtol=RTOL)
    k1, k2 = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    starts = tuple(np.asarray(jax.random.normal(
        k, (a_ref.nrows, jcfg.coarsening_near_null_dim - 1), jnp.float64))
        for k in (k1, k2))
    solver = AMGSolver.setup(
        problems.unstructured_elasticity_3d(SETUP_SIDE), cfg,
        near_null_starts=starts,
        lambda_starts=reference_lambda_starts(JaxSolver._mg_config(jcfg),
                                              ref.hierarchy))
    x, info = solver.solve(b, rtol=RTOL)
    return ref, np.asarray(x_ref), ref_info, solver, x.numpy(), info, starts


def test_elasticity_setup_matches_jax(setup_pair):
    ref, x_ref, ref_info, solver, x, info, _ = setup_pair
    assert solver.hierarchy.num_levels == ref.hierarchy.num_levels >= 2
    for got, want in zip(solver.hierarchy.matrices, ref.hierarchy.matrices):
        assert got.shape == want.shape and got.nnz == want.nnz
        assert got.block_size == want.block_size
    assert info.converged and bool(ref_info.converged)
    assert info.iters == int(ref_info.iters) == 12
    assert np.abs(x - x_ref).max() <= 1e-8 * np.abs(x_ref).max()


def test_elasticity_f32_bootstrap_converges_alike(setup_pair):
    """The whole setup with the float32 bootstrap from the same draws:
    the chip run's bar (the float64 count + 2) on the CPU."""
    *_, info, starts = setup_pair
    cfg = elasticity_3d_config("cpu", bootstrap_dtype=torch.float32, **CUT)
    a = problems.unstructured_elasticity_3d(SETUP_SIDE)
    solver = AMGSolver.setup(a, cfg, near_null_starts=starts)
    b = a.to_scipy() @ np.random.default_rng(5).standard_normal(a.nrows)
    x, info32 = solver.solve(b, rtol=RTOL)
    assert info32.converged and info32.iters <= info.iters + 2
    res = np.linalg.norm(b - a.to_scipy() @ x.numpy()) / np.linalg.norm(b)
    assert res <= 1.01 * RTOL


# ---- the float32 bootstrap against the JAX package's float32 loop

F32_PROBLEMS = {
    "elasticity": ("unstructured_elasticity_3d", 6, 11, 8),
    "poisson": ("unstructured_poisson_3d", 10, 7, 10),
}


def _projector(v):
    q, _ = np.linalg.qr(v)
    return q @ q.T


@pytest.fixture(scope="module", params=list(F32_PROBLEMS))
def f32_case(request):
    _need_jax()
    name, side, k, iters = F32_PROBLEMS[request.param]
    a_ref = getattr(jax_problems, name)(side)
    a = getattr(problems, name)(side)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                      (a.nrows, k), jnp.float32))
    return a_ref, a, x0, iters


@pytest.mark.parametrize("phase", ["l1", "block"])
def test_f32_smoothing_matches_jax(f32_case, phase):
    a_ref, a, x0, iters = f32_case
    op_ref = jax_aslinearoperator(a_ref, dtype=jnp.float32)
    op = SparseOperator.from_csr(a, "cpu", torch.float32)
    # the l1 diagonal as the JAX accelerator branch forms it: 1 / abs
    # row sums, cast to f32 (tpu_amg/adaptivity.py:250-256)
    m_ref = JaxDiagonalOperator(
        diag=jnp.asarray(1.0 / np.asarray(a_ref.abs_row_sums()), jnp.float32))
    m = DiagonalOperator(
        diag=torch.from_numpy(1.0 / a.abs_row_sums()).float())
    if phase == "block":
        x1, _ = jax_adaptivity._smooth_loop(op_ref, m_ref, jnp.asarray(x0),
                                            iters)
        x1 = np.asarray(x1, np.float64)
        part = JaxPartitionerConfig(
            coarsening_factor=min(16.0, max(a.nrows / a.block_size / 2, 1.0)),
            max_improvement_iters=50,
        ).build_partition(a_ref, x1, jax_create_weights(a_ref, x1)
                          ).expand_blocks(a.block_size)
        m_ref = JaxBlockSmoother.build(a_ref, part, dtype=jnp.float32)
        m = BlockSmoother.build(a, Partition(np.asarray(part.node_to_agg)),
                                "cpu", dtype=torch.float32)
    x_ref, cf_ref = jax_adaptivity._smooth_loop(op_ref, m_ref,
                                                jnp.asarray(x0), iters)
    assert x_ref.dtype == jnp.float32
    x, cf = smooth_vector(op, m, iters, x0.shape[1], x0=x0, device="cpu",
                          dtype=torch.float32)
    assert x.dtype == np.float64 and x.shape == x0.shape
    cf_ref = np.asarray(cf_ref, np.float64)
    assert np.all((cf > 0) & (cf < 1))
    assert np.abs(cf - cf_ref).max() <= F32_TOL
    diff = np.abs(_projector(x) - _projector(np.asarray(x_ref, np.float64)))
    assert diff.max() <= F32_TOL


def test_bootstrap_default_is_float64():
    """``find_near_null`` without a dtype is the float64 bootstrap bit
    for bit (so every earlier bootstrap parity test runs what it ran);
    float32 returns a float64 basis near it."""
    a = problems.unstructured_elasticity_3d(5)
    rng = np.random.default_rng(0)
    starts = tuple(rng.standard_normal((a.nrows, 5)) for _ in range(2))
    base = find_near_null(a, 6, 5, 16.0, "cpu", starts=starts)
    f64 = find_near_null(a, 6, 5, 16.0, "cpu", starts=starts,
                         dtype=torch.float64)
    f32 = find_near_null(a, 6, 5, 16.0, "cpu", starts=starts,
                         dtype=torch.float32)
    np.testing.assert_array_equal(base, f64)
    assert f32.dtype == np.float64 and f32.shape == base.shape
    assert np.abs(_projector(f32) - _projector(base)).max() <= 1e-3
    assert SolverConfig(device="cpu").bootstrap_dtype == torch.float64


@pytest.mark.parametrize("method", ["sa", "adaptive"])
def test_setup_draws_are_the_setups_own(method):
    """``setup_draws`` gives the blocks ``AMGSolver.setup`` draws from
    ``config.seed``: passing them gives the same hierarchies bit for bit
    (the chip run's float32 bootstrap starts from its float64 setup's
    draws so)."""
    if method == "sa":
        a = problems.unstructured_elasticity_3d(5)
        cfg = elasticity_3d_config("cpu", coarsest_dim=100,
                                   dense_threshold=200)
    else:
        a = problems.anisotropic_diffusion_2d(12, epsilon=1e-2,
                                              coefficient="random")
        cfg = SolverConfig(method="adaptive", composite_components=2,
                           coarsening_near_null_dim=4, smoothing_iters=5,
                           coarsest_dim=30, dense_threshold=40,
                           coarsening_factor=4.0, device="cpu", seed=42)
    starts, blocks = setup_draws(a.nrows, cfg)
    assert len(blocks) == (1 if method == "adaptive" else 0)
    own = AMGSolver.setup(a, cfg)
    given = AMGSolver.setup(a, cfg, near_null_starts=starts,
                            enrichment_starts=blocks)
    hs = ([own.hierarchy], [given.hierarchy]) if method == "sa" else (
        own.component_hierarchies, given.component_hierarchies)
    assert len(hs[0]) == len(hs[1])
    for h0, h1 in zip(*hs):
        for m0, m1 in zip(h0.matrices + h0.interpolations,
                          h1.matrices + h1.interpolations):
            np.testing.assert_array_equal(m0.data, m1.data)
            np.testing.assert_array_equal(m0.indices, m1.indices)


# ---- the tools on the CPU

def test_setup3d_solve3d_elasticity(tmp_path, capsys):
    from tpu_amg_torch.tools import setup3d, solve3d

    ckpt = str(tmp_path / "e.npz")
    assert setup3d.main(["--elasticity", "--side", "6", "--device", "cpu",
                         "--out", ckpt, "--bootstrap-dtype", "f32"]) == 0
    assert "bootstrap f32" in capsys.readouterr().err
    assert solve3d.main(["--elasticity", "--side", "6", "--device", "cpu",
                         "--ckpt", ckpt, "--reps", "2"]) == 0
    out = capsys.readouterr()
    assert "level 0: n=648" in out.err and "block=3" in out.err
    import json

    rec = json.loads(out.out.strip().splitlines()[-1])
    assert rec["converged"] and rec["true_rel_residual"] <= 1.01 * RTOL
    assert rec["vcycle_device_ms"] is None and rec["device"] == "cpu"


def test_bench_elasticity_cpu(capsys):
    from tpu_amg_torch.tools import bench_elasticity

    assert bench_elasticity.main(["--n", "4", "--device", "cpu",
                                  "--reps", "1"]) == 0
    import json

    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec["formats"]) == {"csr", "dia", "csr_bf16v", "dia_bf16v"}
    assert rec["converged"] and rec["converged_bf16_values"]


def test_bootstrap_study_cpu(capsys):
    """One problem, one seed, both dtypes, in a spawned worker."""
    from tpu_amg_torch.tools import bootstrap_study

    assert bootstrap_study.main(["--problems", "elasticity", "--side", "5",
                                 "--seeds", "0", "--workers", "1",
                                 "--device", "cpu"]) == 0
    import json

    recs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["bootstrap"] for r in recs] == ["float64", "float32"]
    for r in recs:
        assert r["converged"] and len(r["iters"]) == 3
        assert r["rows"] == [[375]] and "near_null" in r["seconds"]


def test_setup_job_checkpoint_probe(tmp_path):
    """A job with a checkpoint and a probe seed (``chip_smoke.py``'s phase
    14): the checkpoint it saved, loaded here, applies bitwise as the
    setup's own composite did to the seed's vector."""
    from tpu_amg_torch.tools import bootstrap_study

    job = dict(kind="adaptive", side=32, bootstrap="float64", device="cpu",
               ckpt=str(tmp_path / "composite.npz"), probe_seed=7)
    out = bootstrap_study.setup_job(job)
    a, cfg = bootstrap_study.problem(job)
    loaded = AMGSolver.load(job["ckpt"], a, cfg)
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(a.nrows))
    assert out["probe"].shape == (a.nrows,) and "iters" not in out
    np.testing.assert_array_equal(
        loaded.apply_preconditioner(r).numpy(), out["probe"])


@pytest.mark.parametrize("cli", ["setup3d", "solve3d", "bench_elasticity",
                                 "profile_setup", "bootstrap_study"])
def test_tools_default_to_the_card(cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"tpu_amg_torch.tools.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# ---- on the card: K1 + K2 at the elasticity path's shapes

@pytest.fixture(scope="module")
def card_hierarchy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = problems.unstructured_elasticity_3d(16)
    solver = AMGSolver.setup(a, elasticity_3d_config("cuda", coarsest_dim=500,
                                                     dense_threshold=600))
    return solver.hierarchy


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["A0", "A1", "P0", "R0"])
@pytest.mark.parametrize("dtype,k", [(torch.float64, 1), (torch.float32, 11)])
def test_k1_k2_at_elasticity_shapes(card_hierarchy, which, dtype, k):
    from tpu_amg_torch.ops import spmv

    letter, lvl = which[0], int(which[1])
    host = {"A": card_hierarchy.matrices, "P": card_hierarchy.interpolations,
            "R": card_hierarchy.restrictions}[letter][lvl]
    mat = spmv.CappedCSR.from_csr(host, "cuda", dtype)
    if which == "A1":
        assert host.block_size == 6 and mat.n_tail > 0  # rows past the cap
    g = torch.Generator(device="cuda").manual_seed(k)
    shape = (mat.shape[1],) if k == 1 else (mat.shape[1], k)
    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    y, again = spmv.spmv(mat, x), spmv.spmv(mat, x)
    p = spmv.plain_spmv(mat, x)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((y - p).abs().max()) <= tol * float(p.abs().max())
    assert torch.equal(y, again)
