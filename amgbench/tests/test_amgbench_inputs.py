"""The benchmark's problem generators: the 7-point Laplacian is the
port's exactly (a frozen copy), and MFEM ex1p's P1 system on its
refined inline triangle mesh is the port's 5-point Laplacian exactly."""

import numpy as np
import pytest

from amgbench.problems import fem2d_p1, poisson3d_7pt


def test_poisson3d_is_the_ports():
    from tpu_amg_torch.utils.problems import poisson3d

    ours = poisson3d_7pt.make({"n": 6})
    port = poisson3d(6)
    assert ours["grid"] == (6, 6, 6)
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(ours[key], getattr(port, key))
        assert ours[key].dtype == getattr(port, key).dtype


def test_ex1p_refines_as_ex1p():
    # the inline mesh's 32 triangles: 4 serial levels (8,192 elements)
    # under 10,000, then 2 parallel ones
    assert fem2d_p1.refinements(4, 4, 10000, 2) == 6
    assert fem2d_p1.refinements(4, 4, 8192, 2) == 6
    assert fem2d_p1.refinements(4, 4, 8191, 2) == 5
    assert fem2d_p1.refinements(4, 4, 10, 2) == 2


@pytest.mark.parametrize("max_serial_elements, side", [(100, 16), (512, 64)])
def test_ex1p_matrix_is_the_5_point_laplacian(max_serial_elements, side):
    """P1 on the uniformly refined inline triangle mesh, zero entries of
    the element matrices skipped, is the 5-point Laplacian (h-free in
    2-D) on the interior grid: the port's generator, exactly."""
    from tpu_amg_torch.utils.problems import poisson2d

    ours = fem2d_p1.make({"nx": 4, "ny": 4, "sx": 1.0, "sy": 1.0,
                          "max_serial_elements": max_serial_elements,
                          "par_ref_levels": 2})
    port = poisson2d(side - 1)
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(ours[key], getattr(port, key))
        assert ours[key].dtype == getattr(port, key).dtype


def test_p1_assembly_on_a_jittered_mesh():
    """The assembly itself, away from the uniform mesh: rows sum to zero
    (constants are in the kernel of −Δ), A is symmetric positive
    semi-definite, and A reproduces ∫∇u·∇v for linear u exactly."""
    pts, tris, _ = fem2d_p1.mesh(6, 5, 1.0, 1.0)
    rng = np.random.default_rng(3)
    pts = pts + rng.uniform(-0.04, 0.04, pts.shape)
    a = fem2d_p1.assemble(pts, tris).toarray()
    np.testing.assert_allclose(a.sum(axis=1), 0.0, atol=1e-12)
    np.testing.assert_allclose(a, a.T, atol=1e-13)
    assert np.linalg.eigvalsh(a).min() > -1e-12
    # u = x, v = y: ∫∇u·∇v = 0; u = v = x: ∫|∇u|² = the domain's area
    p0, p1, p2 = (pts[tris[:, k]] for k in range(3))
    area = np.abs((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                  - (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1])).sum() / 2
    x, y = pts[:, 0], pts[:, 1]
    assert x @ a @ y == pytest.approx(0.0, abs=1e-12)
    assert x @ a @ x == pytest.approx(area, rel=1e-12)
