"""MFEM and MatrixMarket I/O, and the adaptive composite's checkpoint
archive, against the JAX package.

The fixture is written into ``tmp_path`` by the JAX package's own tool
(``tools/make_fem_fixture.py --out``), which edits nothing else; the
port's counterpart (``python -m tpu_amg_torch.tools.make_fem_fixture``)
writes the same bytes.  Both loaders read it into the same arrays.  A
composite archive written by either package loads in the other.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from tests.test_torch_adaptivity import ANISO, _adaptive_kwargs
from tpu_amg.adaptivity import AdaptiveConfig as JaxAdaptiveConfig
from tpu_amg.sparse.csr import CSR as JaxCSR
from tpu_amg.utils import checkpoint as jax_checkpoint
from tpu_amg.utils import io as jax_io
from tpu_amg.utils.problems import anisotropic_diffusion_2d as jax_aniso
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.utils import checkpoint, io

ROOT = Path(__file__).resolve().parents[1]
NAME = "fem_square_k100"


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """(the JAX tool's fixture directory, the port tool's)."""
    base = tmp_path_factory.mktemp("fem")
    out = {}
    for who, cmd in (("jax", ["tools/make_fem_fixture.py"]),
                     ("port", ["-m", "tpu_amg_torch.tools.make_fem_fixture"])):
        out[who] = base / who / NAME
        subprocess.run([sys.executable, *cmd, "--side", "16", "--out",
                        str(out[who])], cwd=ROOT, check=True,
                       capture_output=True)
    return out["jax"], out["port"]


def test_fixture_tools_write_the_same_files(fixture_dirs):
    ref, mine = fixture_dirs
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in mine.iterdir())
    assert {f"{NAME}.{ext}" for ext in ("mtx", "bdy", "coords", "rhs",
                                        "vtk")} == set(names)
    for name in names:
        assert (ref / name).read_bytes() == (mine / name).read_bytes(), name


@pytest.mark.parametrize("delete_boundary", [True, False])
def test_mfem_loader_matches_jax(fixture_dirs, delete_boundary):
    ref_dir, _ = fixture_dirs
    want = jax_io.load_mfem_linear_system(ref_dir, NAME, delete_boundary)
    got = io.load_mfem_linear_system(ref_dir, NAME, delete_boundary)
    for field in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got.matrix, field),
                                      getattr(want.matrix, field))
    assert got.matrix.shape == want.matrix.shape
    for field in ("rhs", "coords", "boundary_indices"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for field in ("mesh_to_solution", "solution_to_mesh"):
        np.testing.assert_array_equal(getattr(got.index_mapping, field),
                                      getattr(want.index_mapping, field))
    assert got.original_dimension == want.original_dimension == 256
    assert got.mesh_geometry is not None
    np.testing.assert_array_equal(got.mesh_geometry.points,
                                  want.mesh_geometry.points)
    np.testing.assert_array_equal(got.mesh_geometry.cells,
                                  want.mesh_geometry.cells)
    if delete_boundary:
        assert got.matrix.nrows == 256 - len(got.boundary_indices)


def test_find_associated_vtk_walks_up(fixture_dirs, tmp_path):
    ref_dir, _ = fixture_dirs
    assert io.find_associated_vtk(ref_dir, NAME) == ref_dir / f"{NAME}.vtk"
    deeper = ref_dir / "a" / "b"
    deeper.mkdir(parents=True, exist_ok=True)
    assert io.find_associated_vtk(deeper, NAME) == ref_dir / f"{NAME}.vtk"
    assert io.find_associated_vtk(tmp_path, "no_such_mesh") is None


def _random_csr(seed, shape=(9, 7)):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal(shape) * (rng.random(shape) < 0.4)
    return dense


@pytest.mark.parametrize("symmetric", [False, True])
def test_matrix_market_round_trip(tmp_path, symmetric):
    dense = _random_csr(1, (8, 8) if symmetric else (9, 7))
    if symmetric:
        dense = dense + dense.T
    mine = CSR.from_dense(dense)
    io.save_matrix_market(tmp_path / "port.mtx", mine, symmetric=symmetric)
    jax_io.save_matrix_market(tmp_path / "jax.mtx", JaxCSR.from_dense(dense),
                              symmetric=symmetric)
    assert ((tmp_path / "port.mtx").read_bytes()
            == (tmp_path / "jax.mtx").read_bytes())
    got = io.load_matrix_market(tmp_path / "jax.mtx")
    want = jax_io.load_matrix_market(tmp_path / "port.mtx")
    np.testing.assert_array_equal(got.to_dense(), dense)
    np.testing.assert_array_equal(want.to_dense(), dense)


def test_mfem_writer_round_trip(tmp_path):
    dense = _random_csr(2, (6, 6))
    dense = dense + dense.T + 8 * np.eye(6)
    rhs = np.arange(12.0).reshape(6, 2)
    coords = np.random.default_rng(3).random((6, 2))
    io.save_mfem_linear_system(tmp_path, "sys", CSR.from_dense(dense), rhs,
                               coords, np.array([0, 5]))
    got = jax_io.load_mfem_linear_system(tmp_path, "sys")
    np.testing.assert_array_equal(got.matrix.to_dense(), dense[1:5, 1:5])
    np.testing.assert_array_equal(got.rhs, rhs[1:5])
    np.testing.assert_array_equal(got.coords, coords[1:5])
    assert got.mesh_geometry is None


def test_bad_inputs_raise(tmp_path):
    (tmp_path / "x.mtx").write_text("not a header\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        io.load_matrix_market(tmp_path / "x.mtx")
    (tmp_path / "x.vtk").write_text("# vtk\nt\nBINARY\n")
    with pytest.raises(ValueError, match="ASCII"):
        io.load_vtk_triangle_mesh(tmp_path / "x.vtk")


# ---- the adaptive composite's archive, in both directions


def _assert_hierarchies_equal(got, want, atol=1e-15):
    assert len(got) == len(want) >= 2
    for h, w in zip(got, want):
        assert h.num_levels == w.num_levels
        assert h.partition_kinds == w.partition_kinds
        assert h.config.coarsest_dim == w.config.coarsest_dim
        for lists in ("matrices", "interpolations", "restrictions"):
            for m, r in zip(getattr(h, lists), getattr(w, lists)):
                assert m.shape == r.shape and m.block_size == r.block_size
                np.testing.assert_array_equal(m.indptr, r.indptr)
                np.testing.assert_array_equal(m.indices, r.indices)
                np.testing.assert_allclose(m.data, r.data, rtol=0, atol=atol)
        for lists in ("near_nulls", "nn_weights"):
            for m, r in zip(getattr(h, lists), getattr(w, lists)):
                np.testing.assert_allclose(m, r, rtol=0, atol=atol)
        for p, q in zip(h.partitions, w.partitions):
            np.testing.assert_array_equal(p.node_to_agg, q.node_to_agg)


@pytest.fixture(scope="module")
def jax_components():
    _, hs = JaxAdaptiveConfig(**_adaptive_kwargs(True, 2)).build(
        jax_aniso(12, **ANISO), jax.random.PRNGKey(1),
        return_hierarchies=True)
    return hs


def test_jax_composite_archive_loads_in_port(jax_components, tmp_path):
    path = tmp_path / "jax.npz"
    jax_checkpoint.save_composite_hierarchies(path, jax_components)
    _assert_hierarchies_equal(checkpoint.load_composite_hierarchies(path),
                              jax_components)
    with pytest.raises(ValueError, match="load_composite_hierarchies"):
        checkpoint.load_hierarchy(path)


def test_port_composite_archive_loads_in_jax(jax_components, tmp_path):
    path = tmp_path / "jax.npz"
    jax_checkpoint.save_composite_hierarchies(path, jax_components)
    mine = checkpoint.load_composite_hierarchies(path)
    again = tmp_path / "port.npz"
    checkpoint.save_composite_hierarchies(again, mine)
    _assert_hierarchies_equal(
        jax_checkpoint.load_composite_hierarchies(again), jax_components)
    single = tmp_path / "single.npz"
    checkpoint.save_hierarchy(single, mine[0])
    with pytest.raises(ValueError, match="load_hierarchy"):
        checkpoint.load_composite_hierarchies(single)
