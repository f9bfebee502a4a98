"""The port's distributed path against the JAX package's sharded path.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, on
a ``make_solver_mesh(W)`` of W = 2 and 4.  The port's side runs as gloo
ranks on the CPU (``tests/torch_dist_worker.py``, started once by
``parallel.multihost.launch``): a world of 8, whose first 1, 2, 4 and 8
ranks make the solver groups.  Inputs are made from a
numpy seed and handed over as arrays; the hierarchy goes across as the
JAX package's archive, with its Chebyshev start vectors.  Each launch
has its own time limit.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cycle import reference_lambda_starts
from tpu_amg.hierarchy import HierarchyConfig as JaxHierarchyConfig
from tpu_amg.hierarchy import create_weights as jax_create_weights
from tpu_amg.interpolation import AggregationConfig as JaxAggregationConfig
from tpu_amg.interpolation import InterpolationConfig as JaxInterpolationConfig
from tpu_amg.linop import DiagonalOperator as JaxDiagonalOperator
from tpu_amg.linop import SparseOperator as JaxSparseOperator
from tpu_amg.parallel import HaloDIA as JaxHaloDIA
from tpu_amg.parallel import HaloELL, halo_spmv
from tpu_amg.parallel import make_solver_mesh as jax_mesh
from tpu_amg.parallel import pad_ell_identity
from tpu_amg.parallel import shard_multigrid as jax_shard_multigrid
from tpu_amg.parallel import shard_ell as jax_shard_ell
from tpu_amg.parallel import shard_operator as jax_shard_operator
from tpu_amg.parallel.dist import shard_vector as jax_shard_vector
from tpu_amg.partition import PartitionerConfig as JaxPartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import (
    MultigridConfig as JaxMultigridConfig,
)
from tpu_amg.preconditioners.smoothers import l1_inverse_diag as jax_l1
from tpu_amg.solvers import cg as jax_cg
from tpu_amg.sparse import CSR as JaxCSR
from tpu_amg.sparse import ELL
from tpu_amg.sparse.dia import DIA as JaxDIA
from tpu_amg.utils import checkpoint as jax_checkpoint
from tpu_amg.utils.problems import poisson1d, poisson2d, poisson3d
from tpu_amg.utils.problems import unstructured_poisson_2d
from tests.torch_dist_worker import (ELL_SYSTEM, ELL_WIDTHS, HALO_CASES,
                                     PCG_RTOL, REPLICATE_BELOW)
from tpu_amg_torch.ops import native
from tpu_amg_torch.parallel.dist import (pad_csr_identity, set_group,
                                         shard_ell)
from tpu_amg_torch.parallel.dist import pad_ell_identity as port_pad_ell
from tpu_amg_torch.parallel.halo import HaloCSR
from tpu_amg_torch.parallel.halo import HaloELL as PortHaloELL
from tpu_amg_torch.parallel.multihost import launch
from tpu_amg_torch.shard_utils import SolverGroup
from tpu_amg_torch.solvers.graph import GraphStep
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ell import ELL as PortELL

WIDTHS = (2, 4)  # the JAX side's meshes
LAUNCH_TIMEOUT = 240  # seconds the world of ranks may take


def _transfer():
    """An aggregate-ordered smoothed restriction (64, 512): coarse row r
    reaches fine nodes [8r - 3, 8r + 11), so rows overlap and a rank's
    rows reach past its column window."""
    rng = np.random.default_rng(3)
    rows, cols = [], []
    for r in range(64):
        c = np.arange(max(8 * r - 3, 0), min(8 * r + 11, 512))
        rows.append(np.full(c.size, r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return JaxCSR.from_coo(rows, cols, rng.uniform(0.5, 1.5, rows.size),
                           (64, 512))


def _inputs():
    rng = np.random.default_rng(0)
    mats = {"poisson2d": poisson2d(16), "unstructured2d":
            unstructured_poisson_2d(32), "transfer": _transfer(),
            "poisson3d_dia": poisson3d(8), ELL_SYSTEM: poisson2d(15)}
    arrays = {}
    for name, m in mats.items():
        for f in ("data", "indices", "indptr"):
            arrays[f"{name}_{f}"] = np.asarray(getattr(m, f))
        arrays[f"{name}_shape"] = np.asarray(m.shape)
    for name in HALO_CASES:
        m = mats[name.removesuffix("_mm")]
        shape = (m.shape[1], 4) if name.endswith("_mm") else (m.shape[1],)
        arrays[f"x_{name}"] = rng.standard_normal(shape)
    return mats, arrays


def _jax_multigrid():
    """poisson2d(32): levels 1,024 / 292 / 93 / 21; level 0's block
    smoother, Chebyshev below, the banded coarse solve."""
    a = poisson2d(32)
    nn = np.ones((a.nrows, 1))
    h = JaxHierarchyConfig(
        coarsest_dim=40, max_levels=4,
        interpolation_config=JaxInterpolationConfig(
            kind="aggregation", aggregation=JaxAggregationConfig(
                candidate_dimension=1,
                partitioner_config=JaxPartitionerConfig(
                    coarsening_factor=4.0, max_improvement_iters=5))),
    ).build(a, nn, jax_create_weights(a, nn))
    cfgs = {kind: JaxMultigridConfig(
        smoothing_steps=1, smoother=kind, coarse_solver="banded",
        dense_threshold=0, prefer_dia=False,
        smoother_partitioner=JaxPartitionerConfig(
            coarsening_factor=16.0, max_improvement_iters=5))
        for kind in ("chebyshev", "block")}
    built = {kind: cfg.build(h) for kind, cfg in cfgs.items()}
    mg = dataclasses.replace(
        built["chebyshev"],
        levels=(built["block"].levels[0],) + built["chebyshev"].levels[1:])
    return a, h, mg, reference_lambda_starts(cfgs["chebyshev"], h)


def _jax_ell_system(a, mesh, w) -> dict:
    """The padded ELL system's PCG on the JAX side: ``shard_operator``
    (its ``HaloELL``) and ``shard_ell`` (the row-sharded gather)."""
    ell = pad_ell_identity(ELL.from_csr(a), w)
    m = JaxDiagonalOperator(diag=jax_l1(ell))
    b = jax_shard_vector(jnp.ones(ell.nrows), mesh)
    out = {}
    for form, op in (
            ("halo", jax_shard_operator(JaxSparseOperator(ell=ell), mesh)),
            ("gather", JaxSparseOperator(ell=jax_shard_ell(ell, mesh)))):
        x, info = jax.jit(lambda a_, b_, m_: jax_cg(a_, b_, m_,
                                                    rtol=PCG_RTOL))(op, b, m)
        out[f"ell_{form}_x_{w}"] = np.asarray(x)
        out[f"ell_{form}_iters_{w}"] = int(info.iters)
        if form == "halo":
            out[f"ell_halo_fine_{w}"] = type(op.ell).__name__
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the JAX side's outputs, the port's outputs by world)."""
    d = tmp_path_factory.mktemp("dist")
    mats, arrays = _inputs()
    np.savez(d / "inputs.npz", **arrays)
    a, h, mg, lam = _jax_multigrid()
    jax_checkpoint.save_hierarchy(d / "hierarchy.npz", h)
    np.savez(d / "lam.npz", **{f"l{i}": v for i, v in enumerate(lam)})
    native.lib()  # built here once, not by every rank at its first use
    # the port's ranks run while the JAX side computes
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(launch, "tests.torch_dist_worker", [str(d)], 8,
                          LAUNCH_TIMEOUT)
        ref = {}
        for w in WIDTHS:
            mesh = jax_mesh(w)
            ctx = jax.set_mesh(mesh)
            try:
                for name in HALO_CASES:
                    m = mats[name.removesuffix("_mm")]
                    hop = (JaxHaloDIA.from_dia(JaxDIA.from_csr(m), mesh)
                           if name == "poisson3d_dia"
                           else HaloELL.from_ell(ELL.from_csr(m), mesh))
                    ref[f"y_{name}_{w}"] = np.asarray(halo_spmv(
                        hop, jax_shard_vector(jnp.asarray(
                            arrays[f"x_{name}"]), mesh)))
                if w in ELL_WIDTHS:
                    ref.update(_jax_ell_system(mats[ELL_SYSTEM], mesh, w))
                sop = jax_shard_operator(
                    JaxSparseOperator.from_csr(a, prefer_dia=False), mesh)
                mg_sh = jax_shard_multigrid(mg, mesh,
                                            replicate_below=REPLICATE_BELOW)
                x, info = jax.jit(lambda a_, b_, m_: jax_cg(
                    a_, b_, m_, rtol=PCG_RTOL))(
                    sop, jax_shard_vector(jnp.ones(a.nrows), mesh), mg_sh)
                ref[f"pcg_x_{w}"] = np.asarray(x)
                ref[f"pcg_iters_{w}"] = int(info.iters)
            finally:
                ctx.__exit__(None, None, None)
        job.result()
    with np.load(d / "port.npz") as z:
        port = {k: z[k] for k in z.files}
    return mats, arrays, ref, port


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", HALO_CASES)
def test_halo_spmv_matches_jax(runs, name, w):
    _, _, ref, port = runs
    got = port[f"y_{name}_{w}"]
    assert got.shape == ref[f"y_{name}_{w}"].shape
    assert _rel(got, ref[f"y_{name}_{w}"]) <= 1e-12
    if name != "poisson3d_dia":
        assert port[f"halo_{name}_{w}"] > 0


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", [c for c in HALO_CASES
                                  if c != "poisson3d_dia"])
def test_halo_ell_spmv_matches_jax(runs, name, w):
    """Each CSR case as a ``HaloELL``: the JAX package's ``HaloELL``
    apply to 1e-12, with a halo."""
    _, _, ref, port = runs
    assert _rel(port[f"y_ell_{name}_{w}"], ref[f"y_{name}_{w}"]) <= 1e-12
    assert port[f"halo_ell_{name}_{w}"] == port[f"halo_{name}_{w}"] > 0


@pytest.mark.parametrize("form", ["halo", "gather"])
@pytest.mark.parametrize("w", ELL_WIDTHS)
def test_sharded_ell_pcg_matches_jax(runs, w, form):
    """poisson2d(15) as an ELL padded by ``pad_ell_identity`` to a
    multiple of w, PCG with the l1 diagonal over w gloo ranks through
    ``HaloELL`` and through ``shard_ell``: the JAX package's iterations,
    its x to 1e-10."""
    _, _, ref, port = runs
    assert int(port[f"ell_rows_{w}"]) == -(-225 // w) * w
    if form == "halo":
        assert str(port[f"ell_halo_fine_{w}"]) == "HaloELL" == \
            ref[f"ell_halo_fine_{w}"]
        assert int(port[f"ell_halo_{w}"]) > 0
    assert int(port[f"ell_{form}_iters_{w}"]) == ref[f"ell_{form}_iters_{w}"]
    assert _rel(port[f"ell_{form}_x_{w}"], ref[f"ell_{form}_x_{w}"]) <= 1e-10


@pytest.mark.parametrize("name", HALO_CASES)
def test_halo_spmv_at_eight_ranks(runs, name):
    mats, arrays, _, port = runs
    want = mats[name.removesuffix("_mm")].to_dense() @ arrays[f"x_{name}"]
    assert _rel(port[f"y_{name}_8"], want) <= 1e-12


@pytest.mark.parametrize("w", WIDTHS)
def test_sharded_pcg_matches_jax(runs, w):
    """The sharded PCG + V-cycle (level 0 sharded with its block
    smoother, level 1 sharded with Chebyshev, level 2 replicated, the
    banded coarse solve): the JAX sharded solve's iterations, its x to
    1e-10."""
    _, _, ref, port = runs
    forms = json.loads(str(port[f"pcg_forms_{w}"]))
    assert forms[0] == "HaloDIA" and forms[1] != "replicated"
    assert forms[2] == "replicated"
    assert int(port[f"pcg_iters_{w}"]) == ref[f"pcg_iters_{w}"]
    assert _rel(port[f"pcg_x_{w}"], ref[f"pcg_x_{w}"]) <= 1e-10


def test_world_size_one_is_the_unsharded_port(runs):
    """A solver group of one rank: halo 0, the unsharded matrices."""
    port = runs[3]
    assert bool(port["w1_pcg_bitwise"]) and bool(port["w1_spmv_bitwise"])
    assert int(port["pcg_iters_1"]) == runs[2]["pcg_iters_2"]


def test_scaling_sweep(runs):
    """1 → 2 → 4 → 8 ranks at fixed rows a rank: each shard's nnz stays
    put, the bytes at one boundary do not grow with the width (surface,
    not volume), and sharded equals one rank at every width."""
    recs = json.loads(str(runs[3]["sweep"]))
    assert [r["ranks"] for r in recs] == [1, 2, 4, 8]
    nnz_1 = recs[0]["nnz_per_shard"][0]
    for r in recs:
        assert r["spmv_equal"] and r["pcg_rel_err"] <= 1e-10
        # a cut adds the neighbour line's entries (one a boundary node)
        strip = r["grid"][1]
        assert all(nnz_1 <= v <= nnz_1 + 2 * strip
                   for v in r["nnz_per_shard"])
    per_boundary = {r["bytes_per_boundary"] for r in recs[1:]}
    assert len(per_boundary) == 1 and per_boundary.pop() > 0
    assert [r["bytes_per_spmv"] for r in recs] == [
        recs[1]["bytes_per_spmv"] * (r["ranks"] - 1) for r in recs]


def test_pad_csr_identity_is_pad_ell_identity():
    a = poisson1d(12)  # 11 dofs -> 16
    ref = pad_ell_identity(ELL.from_csr(a), 8)
    got = pad_csr_identity(CSR(data=np.asarray(a.data),
                               indices=np.asarray(a.indices),
                               indptr=np.asarray(a.indptr),
                               shape=a.shape), 8)
    assert got.shape == ref.shape == (16, 16)
    np.testing.assert_array_equal(got.to_dense(), ref.to_csr().to_dense())
    assert got.nnz == ref.nnz


def test_pad_ell_identity_matches_jax():
    a = poisson1d(12)  # 11 dofs -> 16
    ref = pad_ell_identity(ELL.from_csr(a), 8)
    got = port_pad_ell(PortELL.from_csr(CSR(
        data=np.asarray(a.data), indices=np.asarray(a.indices),
        indptr=np.asarray(a.indptr), shape=a.shape), "cpu"), 8)
    assert (got.shape, got.nnz, got.block_size, got.k) == (
        ref.shape, ref.nnz, ref.block_size, ref.k)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    x = np.random.default_rng(5).standard_normal(16)
    np.testing.assert_allclose(got.mv(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.mv(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    assert port_pad_ell(got, 8) is got


def test_shard_ell_refuses_what_jax_refuses():
    """Not an ELL: TypeError; rows the group does not divide: ValueError
    (pad first), in both packages."""
    a = poisson1d(12)
    port = CSR(data=np.asarray(a.data), indices=np.asarray(a.indices),
               indptr=np.asarray(a.indptr), shape=a.shape)
    group = SolverGroup(None, 8, 0, "gloo")
    with pytest.raises(ValueError):
        jax_shard_ell(ELL.from_csr(a), jax_mesh(8))
    with pytest.raises(ValueError, match="pad_ell_identity"):
        shard_ell(PortELL.from_csr(port, "cpu"), group, "cpu")
    with pytest.raises(TypeError):
        jax_shard_ell(JaxDIA.from_csr(a), jax_mesh(8))
    with pytest.raises(TypeError):
        shard_ell(port, group, "cpu")


def test_band_violation_raises():
    """A row spanning every column breaks the band, in both packages."""
    n = 64
    rows = np.concatenate([np.arange(n), np.zeros(n, dtype=int)])
    cols = np.concatenate([np.arange(n), np.arange(n)])
    a = JaxCSR.from_coo(rows, cols, np.ones(2 * n), (n, n))
    with pytest.raises(ValueError):
        HaloELL.from_ell(ELL.from_csr(a), jax_mesh(8))
    port = CSR(data=np.asarray(a.data), indices=np.asarray(a.indices),
               indptr=np.asarray(a.indptr), shape=a.shape)
    for index in (0, 7):  # no collective: the check is on the host
        group = SolverGroup(None, 8, index, "gloo")
        with pytest.raises(ValueError):
            HaloCSR.from_csr(port, group, "cpu")
        with pytest.raises(ValueError):
            PortHaloELL.from_ell(PortELL.from_csr(port, "cpu"), group)


def test_no_cuda_graph_of_a_sharded_step():
    with set_group(SolverGroup(None, 2, 0, "gloo")):
        with pytest.raises(RuntimeError, match="sharded"):
            GraphStep(lambda s: (s, None), (torch.zeros(1),))
