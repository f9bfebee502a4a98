"""Mixed-precision cycles (tpu_amg_torch.precision) against the JAX
package's (tpu_amg.precision), and K1, K2 and K3 on a value stream
narrower than their vectors.

Both packages build one multigrid from the same hierarchy (built by
tpu_amg and loaded by the port from the checkpoint arrays, the
Chebyshev power iterations started from the reference's own draws:
tests.test_torch_cycle), f64, on poisson2d(32), dense at <= 64 rows.
Then both cast it:

- the cast leaves: the same paths (the JAX pytree's, a sparse operator
  compared as the matrix it applies), the same dtypes and bitwise the
  same values, ``lam_max``, ``lam_min`` and ``scale`` included;
- the cycle's mv and mm (k = 3): 1e-10 relative in "f32" and
  "bf16_values", whose vectors stay f64 (the same sums in another
  order); 5e-2 in "bf16", the JAX package's own bound for a bf16
  cycle (tests/test_precision.py): the port's sparse applies are f32
  islands (one rounding), the JAX package's CPU formats sum in bf16;
- PCG to 1e-6: the JAX package's iterations in "bf16_values", within 2
  in "bf16".

The JAX builder stores each level's R as ``BandedDense``, a TPU MXU
format (not ported, by decision) that rounds x to its slabs' dtype and
sums in it (``tpu_amg/sparse/banded.py:86-99``), where every other JAX
format returns ``jnp.result_type`` of values and x.  The port's R is a
capped CSR under the result_type rule.  So the JAX side of the cycle
comparisons carries R (and any banded P) as the same matrix in ``ELL``,
the JAX format of that rule; the cast leaves are compared on the
builder's own cycle.

The adaptive composite (block smoothers, 2 components) is built by both
packages from the same draws on chip_smoke.py's adaptive problem at
1,024 dofs.  Its cast cycle is held against the JAX package's (banded
transfers in ELL) at 1e-10, and its "bf16_values" PCG against the JAX
package's own cycle: neither converges within the f64 count + 3.

The kernels' plain versions at (bf16, f64), (f32, f64) and (bf16, f32)
are held against the JAX formats' mixed-dtype applies (``DIA.mv``,
``ELL.mv``/``mm``: ``jnp.result_type``), 1e-10 relative under f64
vectors and 1e-6 under f32.  K3's band-tile plan and per-tile sum are
restated in numpy for 2-byte data rows (4-byte copies at a row's
phase).  The cases marked ``cuda`` run the kernels on the card against
their plain versions; they skip without one.  JAX is imported where it
is present, so that on a machine with a card and no JAX the card cases
run with ``python -m pytest --noconftest tests/test_torch_precision.py``.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from tpu_amg_torch.linop import DenseOperator, ScaledIdentity, SparseOperator
from tpu_amg_torch.ops import dia as dia_ops
from tpu_amg_torch.ops import spmv
from tpu_amg_torch.precision import (
    MODES,
    MixedPrecision,
    cast_operator,
    cast_preconditioner,
)
from tpu_amg_torch.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg_torch.preconditioners.composite import Composite
from tpu_amg_torch.preconditioners.multigrid import Multigrid
from tpu_amg_torch.solver import AMGSolver, SolverConfig
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import try_from_csr
from tpu_amg_torch.utils.problems import anisotropic_diffusion_2d, poisson2d

try:
    import jax
    import jax.numpy as jnp

    import tests.test_torch_cycle as cycle_tests
    from tests.test_torch_adaptivity import reference_draws
    from tests.test_torch_cycle import reference_lambda_starts
    from tests.test_torch_facade import _jax_hierarchy
    from tpu_amg import precision as jax_precision
    from tpu_amg.linop import aslinearoperator as jax_aslinearoperator
    from tpu_amg.preconditioners.multigrid_builder import (
        MultigridConfig as JaxMultigridConfig,
    )
    from tpu_amg.solver import AMGSolver as JaxSolver
    from tpu_amg.solver import SolverConfig as JaxSolverConfig
    from tpu_amg.solvers import cg as jax_cg
    from tpu_amg.sparse.csr import CSR as JaxCSR
    from tpu_amg.sparse.dia import try_from_csr as jax_try_dia
    from tpu_amg.sparse.ell import ELL as JaxELL
    from tpu_amg.structured import build_structured_multigrid as jax_structured
    from tpu_amg.utils import checkpoint as jax_checkpoint
    from tpu_amg.utils import problems as jax_problems
except ImportError:  # a card without JAX: only the card cases run
    jax = None

RTOL = 1e-10
# "bf16": the JAX package's own bound (tests/test_precision.py:73-84);
# measured on the CPU, the mm (k = 3) of the cycle cases: 6.6e-3
# (Chebyshev), 6.8e-3 (block), 9.5e-3 (structured)
BF16_RTOL = 5e-2
DENSE = 64
KW = dict(smoother="chebyshev", dense_threshold=DENSE)
DTYPE = {"f64": torch.float64, "f32": torch.float32,
         "bf16_values": torch.bfloat16, "bf16": torch.bfloat16}
# the mixed pairs (value dtype, vector dtype) of K1, K2 and K3
MIXED = [(torch.bfloat16, torch.float64), (torch.float32, torch.float64),
         (torch.bfloat16, torch.float32)]
PAIR_TOL = {torch.float64: 1e-10, torch.float32: 1e-6}
CARD_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
SMS = 132  # an H100's SMs


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("needs JAX (the reference package)")


def _rel(got, ref) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _close(got, ref, rtol=RTOL):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _rhs(n, k=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


@pytest.fixture(scope="module")
def hierarchies(needs_jax):
    return cycle_tests.hierarchies.__wrapped__()


@pytest.fixture(scope="module")
def both_multigrids(hierarchies):
    """{smoother: (the JAX multigrid, the port's)}, from one hierarchy."""
    from tpu_amg_torch.preconditioners.multigrid_builder import MultigridConfig

    ref_h, h = hierarchies
    out = {}
    for smoother in ("chebyshev", "block"):
        kw = dict(smoother=smoother, dense_threshold=DENSE)
        jax_cfg = JaxMultigridConfig(**kw)
        out[smoother] = (jax_cfg.build(ref_h),
                         MultigridConfig(device="cpu", **kw).build(
                             h, lambda_starts=reference_lambda_starts(
                                 jax_cfg, ref_h)))
    return out


@pytest.fixture(params=["chebyshev", "block"])
def multigrids(both_multigrids, request):
    return both_multigrids[request.param]


def _as_ell(op):
    """A JAX SparseOperator stored as BandedDense (or a stack of them),
    as the same matrix in ELL; any other operator as it is."""
    from tpu_amg.linop import SparseOperator as JaxSparseOperator

    if "Banded" not in type(getattr(op, "ell", None)).__name__:
        return op
    import scipy.sparse as sps

    m = sps.csr_matrix(np.asarray(op.mm(jnp.eye(op.shape[1]))))
    return JaxSparseOperator(ell=JaxELL.from_csr(JaxCSR(
        data=m.data, indices=m.indices.astype(np.int32),
        indptr=m.indptr.astype(np.int64), shape=m.shape)))


def _result_type_transfers(pc):
    """A JAX multigrid (or composite of them) with its banded transfers
    in ELL (module docstring)."""
    if hasattr(pc, "components"):
        return dataclasses.replace(pc, components=tuple(
            _result_type_transfers(c) for c in pc.components))
    return dataclasses.replace(pc, levels=tuple(
        dataclasses.replace(lvl, r=_as_ell(lvl.r), p=_as_ell(lvl.p))
        for lvl in pc.levels))


# ---- (a) the cast leaves

_SPARSE = re.compile(r"^(.*?)\.(ell|ell_t|well|mat|mat_t)(?=[.\[]|$)")


def _collapse(path: str):
    """A leaf's path with a sparse (or dense) operator's storage cut off:
    (the operator's path, True), else (path, False)."""
    m = _SPARSE.match(path)
    return (m.group(1), True) if m else (path, False)


def _port_leaves(op, path=""):
    """(path, leaf) for every tensor and float of the port's operator
    tree, paths spelled as ``jax.tree_util.keystr`` spells the JAX
    pytree's."""
    if isinstance(op, (torch.Tensor, float)):
        yield path, op
    elif dataclasses.is_dataclass(op) and not isinstance(op, type):
        for f in dataclasses.fields(op):
            yield from _port_leaves(getattr(op, f.name), f"{path}.{f.name}")
    elif isinstance(op, (tuple, list)):
        for i, v in enumerate(op):
            yield from _port_leaves(v, f"{path}[{i}]")


def _jax_leaves(op):
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(op)[0]]


def _is_float(leaf) -> bool:
    if isinstance(leaf, float):
        return True
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return jnp.issubdtype(leaf.dtype, jnp.inexact)


def _at(obj, path: str):
    for name, index in re.findall(r"\.(\w+)|\[(\d+)\]", path):
        obj = getattr(obj, name) if name else obj[int(index)]
    return obj


def _values(leaves) -> np.ndarray:
    """An operator's stored values, the nonzeros of all its float
    leaves, sorted (as float32: exact for bf16 and f32)."""
    flat = np.concatenate([
        (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
         else np.asarray(leaf, np.float32)).ravel() for leaf in leaves])
    return np.sort(flat[flat != 0])


def _grouped(leaves):
    """{collapsed path: (is an operator, [float leaves])}."""
    out = {}
    for path, leaf in leaves:
        if _is_float(leaf):
            key, sparse = _collapse(path)
            out.setdefault(key, (sparse, []))[1].append(leaf)
    return out


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


@pytest.mark.parametrize("mode", ["f32", "bf16_values"])
def test_cast_leaves_match_jax(multigrids, mode):
    """("bf16" casts as "bf16_values" does, inside MixedPrecision.)"""
    ref, mg = multigrids
    ref_c = jax_precision.cast_preconditioner(ref, mode)
    got_c = cast_preconditioner(mg, mode)
    want, got = _grouped(_jax_leaves(ref_c)), _grouped(_port_leaves(got_c))
    assert set(got) == set(want)
    dt = str(DTYPE[mode]).replace("torch.", "")
    names = set()
    for key, (sparse, leaves) in want.items():
        assert got[key][0] == sparse, key
        assert {_dtype_name(leaf) for leaf in leaves} == {dt}, key
        assert {_dtype_name(leaf) for leaf in got[key][1]} == {dt}, key
        if sparse:  # its values, stored in other layouts
            np.testing.assert_array_equal(_values(got[key][1]),
                                          _values(leaves), err_msg=key)
            assert _at(got_c, key).shape == tuple(_at(ref_c, key).shape)
        else:
            (g,), (r,) = got[key][1], leaves
            assert g.shape == r.shape, key
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(r, np.float32), err_msg=key)
        names.add(key.rsplit(".", 1)[-1])
    if isinstance(mg.levels[0].smoother, ChebyshevSmoother):
        assert {"lam_max", "lam_min", "d_inv", "inv"} <= names
        assert isinstance(got_c.levels[0].smoother.lam_max, torch.Tensor)
    else:
        assert {"inv_blocks", "mask", "inv"} <= names
    # integer tensors untouched, structure and static fields kept
    after = dict(_port_leaves(got_c))
    ints = [(p, t) for p, t in _port_leaves(mg)
            if isinstance(t, torch.Tensor) and not t.is_floating_point()]
    assert ints and all(after[p] is t for p, t in ints)
    assert type(got_c) is Multigrid
    assert (got_c.mu, got_c.smoothing_steps) == (mg.mu, mg.smoothing_steps)
    assert len(got_c.levels) == len(mg.levels)
    # a level's A is its smoother's A: cast once, still shared
    for lvl in got_c.levels:
        if isinstance(lvl.smoother, ChebyshevSmoother):
            assert lvl.smoother.a is lvl.a


def test_scaled_identity_scale_is_cast(needs_jax):
    from tpu_amg.linop import ScaledIdentity as JaxScaledIdentity

    ref = jax_precision.cast_operator(
        JaxScaledIdentity(jnp.asarray(1.0 / 3.0), 8), jnp.bfloat16)
    got = cast_operator(ScaledIdentity(1.0 / 3.0, 8), torch.bfloat16)
    assert got.scale.dtype == torch.bfloat16 and got.scale.dim() == 0
    assert float(got.scale) == float(ref.scale)
    x = _rhs(8)
    np.testing.assert_array_equal(got.mv(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.mv(jnp.asarray(x))))


# ---- (b), (c) the cast cycle

@pytest.mark.parametrize("mode", ["f32", "bf16_values", "bf16"])
def test_cycle_matches_jax(multigrids, hierarchies, mode, k=3):
    """The cycle's mm (k = 3); its mv is held by the PCG and load cases."""
    ref, mg = multigrids
    x = _rhs(hierarchies[1].matrices[0].nrows, k)
    want = jax_precision.cast_preconditioner(_result_type_transfers(ref),
                                             mode)(jnp.asarray(x))
    got = cast_preconditioner(mg, mode)(torch.from_numpy(x))
    assert got.dtype == torch.float64
    if mode == "bf16":
        # one rounding a sparse apply (the f32 island) against the JAX
        # CPU formats' bf16 sums
        assert _rel(got, want) <= BF16_RTOL
    else:
        _close(got, want)


@pytest.mark.parametrize("smoother,mode", [
    ("chebyshev", "bf16_values"), ("chebyshev", "bf16")])
def test_pcg_iterations_match_jax(both_multigrids, hierarchies, smoother,
                                  mode):
    ref, mg = both_multigrids[smoother]
    ref_h, h = hierarchies
    b = _rhs(h.matrices[0].nrows, seed=2)
    _, ref_info = jax_cg(jax_aslinearoperator(ref_h.matrices[0]),
                         jnp.asarray(b),
                         jax_precision.cast_preconditioner(
                             _result_type_transfers(ref), mode),
                         rtol=1e-6, maxiter=100)
    _, info = cg_cpu(h.matrices[0], b, cast_preconditioner(mg, mode))
    assert info.converged and bool(ref_info.converged)
    if mode == "bf16":
        assert abs(info.iters - int(ref_info.iters)) <= 2
    else:
        assert info.iters == int(ref_info.iters)


def cg_cpu(a, b, pc, rtol=1e-6, maxiter=100):
    from tpu_amg_torch.solvers import cg

    return cg(SparseOperator.from_csr(a, "cpu"), torch.from_numpy(b), pc,
              rtol=rtol, maxiter=maxiter)


# ---- (d), (e) the wrapper and the modes

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mixed_precision_keeps_the_input_dtype(multigrids, dtype):
    _, mg = multigrids
    m = cast_preconditioner(mg, "bf16")
    n = mg.shape[0]
    assert m.shape == mg.shape
    assert m.mv(torch.ones(n, dtype=dtype)).dtype == dtype
    assert m.mm(torch.ones(n, 3, dtype=dtype)).dtype == dtype
    assert m(torch.ones(n, 3, dtype=dtype)).shape == (n, 3)


def test_modes(multigrids):
    _, mg = multigrids
    for mode in (None, "none"):
        assert cast_preconditioner(mg, mode) is mg
    assert not isinstance(cast_preconditioner(mg, "bf16_values"),
                          MixedPrecision)
    with pytest.raises(ValueError, match="unknown precision mode"):
        cast_preconditioner(mg, "fp8")
    assert set(MODES) == {None, "none", "f64", "f32", "bf16_values", "bf16"}
    # "f64" on an f64 cycle: the floats become f64 0-d tensors, the bits
    # stay
    x = torch.from_numpy(_rhs(mg.shape[0], 3))
    assert torch.equal(cast_preconditioner(mg, "f64")(x), mg(x))


# ---- (f), (g) the facade: setup, load

def _facade_config(mode, **kw):
    return SolverConfig(**{**dict(
        coarsening_near_null_dim=8, smoothing_steps=1, smoothing_iters=5,
        coarsest_dim=64, device="cpu", cycle_precision=mode), **kw})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["f32", "bf16_values", "bf16"])
def test_solver_setup_applies_cycle_precision(mode, dtype):
    a = poisson2d(24)
    solver = AMGSolver.setup(a, _facade_config(mode, dtype=dtype))
    assert solver.op.mat.dtype == dtype  # the operator stays uncast
    inner = solver.preconditioner
    assert isinstance(inner, MixedPrecision) == (mode == "bf16")
    inner = getattr(inner, "inner", inner)
    assert inner.levels[0].a.mat.dtype == DTYPE[mode]
    b = np.random.default_rng(2).standard_normal(a.nrows)
    x, info = solver.solve(b, rtol=1e-6, maxiter=100)
    assert info.converged and x.dtype == dtype
    _, plain = AMGSolver.setup(a, _facade_config(None, dtype=dtype)).solve(
        b, rtol=1e-6, maxiter=100)
    assert info.iters <= plain.iters + 3


def test_adaptive_setup_keeps_the_operator_uncast():
    a = anisotropic_diffusion_2d(12)
    solver = AMGSolver.setup(a, _facade_config(
        "bf16_values", method="adaptive", composite_components=2,
        coarsening_factor=4.0, dense_threshold=30, coarsest_dim=30))
    pc = solver.preconditioner
    assert isinstance(pc, Composite) and len(pc.components) == 2
    assert solver.op is not pc.a
    assert solver.op.mat.dtype == torch.float64
    assert pc.a.mat.dtype == torch.bfloat16
    _, info = solver.solve(np.ones(a.nrows), rtol=1e-6, maxiter=200)
    assert info.converged


# ---- the adaptive composite in "bf16_values", both packages

# chip_smoke.py's adaptive problem (aniso2d, epsilon 1e-3, theta pi/6,
# random coefficients) at 1,024 dofs, under the CLI's adaptive defaults
# with phase 14's small-composite cut (coarsest 100, dense 200)
ADAPTIVE_N = 32
ADAPTIVE_PROBLEM = dict(epsilon=1e-3, theta=np.pi / 6, coefficient="random")
ADAPTIVE_KW = dict(
    method="adaptive", composite_components=2, coarsening_near_null_dim=64,
    interp_near_null_dim=4, smoothing_iters=20, smoother="block",
    block_smoother_size=128.0, smoothing_steps=3, coarsening_factor=8.0,
    aggregation_iters=200, coarsest_dim=100, dense_threshold=200, seed=42)


@pytest.fixture(scope="module")
def adaptive_solvers(needs_jax):
    """(the JAX package's adaptive solver, its composite with the banded
    transfers in ELL, the port's solver), the port's built from the JAX
    package's own draws: the same hierarchies."""
    ref = JaxSolver.setup(
        jax_problems.anisotropic_diffusion_2d(ADAPTIVE_N, **ADAPTIVE_PROBLEM),
        JaxSolverConfig(**ADAPTIVE_KW))
    starts, blocks = reference_draws(
        jax.random.PRNGKey(ADAPTIVE_KW["seed"]), ADAPTIVE_N ** 2,
        ADAPTIVE_KW["coarsening_near_null_dim"],
        ADAPTIVE_KW["composite_components"] - 1)
    got = AMGSolver.setup(
        anisotropic_diffusion_2d(ADAPTIVE_N, **ADAPTIVE_PROBLEM),
        SolverConfig(device="cpu", **ADAPTIVE_KW),
        near_null_starts=starts, enrichment_starts=blocks)
    return ref, _result_type_transfers(ref.preconditioner), got


@pytest.mark.parametrize("mode", ["f32", "bf16_values"])
def test_adaptive_cast_cycle_matches_jax(adaptive_solvers, mode):
    """The cast composite (block smoothers, 2 components) against the
    JAX package's, its banded transfers in ELL (module docstring)."""
    _, ref_pc, got = adaptive_solvers
    x = _rhs(ADAPTIVE_N ** 2, seed=9)
    want = jax.jit(lambda pc, v: pc.mv(v))(
        jax_precision.cast_preconditioner(ref_pc, mode), jnp.asarray(x))
    _close(cast_preconditioner(got.preconditioner, mode).mv(
        torch.from_numpy(x)), want)


def test_adaptive_bf16_values_fails_the_f64_bound_in_both_packages(
        adaptive_solvers):
    """In "bf16_values" neither package's composite converges within the
    f64 count + 3 on this problem.  Measured on the CPU: f64 19
    iterations in both; "bf16_values" the JAX package's own cycle (its
    banded R rounds x to bf16 and sums in bf16) stalls, relative
    residual 0.35 after 100 iterations and 0.41 after 500; its cycle
    with R under the result_type rule takes 66, the port's 69.  The
    cause is in the data: the bf16 rounding of A moves its smallest
    eigenvalue from 6.9e-3 to -0.14, so every cast cycle approximates
    the inverse of an indefinite matrix."""
    from tpu_amg_torch.solvers import cg

    ref, _, got = adaptive_solvers
    b = _rhs(ADAPTIVE_N ** 2, seed=2)
    _, base = cg(got.op, torch.from_numpy(b), got.preconditioner,
                 rtol=1e-6, maxiter=100)
    assert base.converged
    limit = base.iters + 3
    _, own = jax_cg(ref.op, jnp.asarray(b), jax_precision.cast_preconditioner(
        ref.preconditioner, "bf16_values"), rtol=1e-6, maxiter=100)
    assert not bool(own.converged)
    _, info = cg(got.op, torch.from_numpy(b),
                 cast_preconditioner(got.preconditioner, "bf16_values"),
                 rtol=1e-6, maxiter=100)
    assert info.iters > limit
    # the f64 operator is positive definite, its bf16 rounding is not
    dense = torch.from_numpy(got.matrix.to_dense())
    eig = torch.linalg.eigvalsh(dense)
    eig_bf16 = torch.linalg.eigvalsh(dense.to(torch.bfloat16).double())
    assert eig[0] > 0 > eig_bf16[0]


@pytest.fixture(scope="module")
def archive(needs_jax, tmp_path_factory):
    """(the JAX hierarchy, a single archive, a composite archive of it
    twice), both written by the JAX package."""
    ref_h = _jax_hierarchy(16)
    d = tmp_path_factory.mktemp("precision")
    jax_checkpoint.save_hierarchy(d / "single.npz", ref_h)
    jax_checkpoint.save_composite_hierarchies(d / "composite.npz",
                                              [ref_h, ref_h])
    return ref_h, d / "single.npz", d / "composite.npz"


@pytest.mark.parametrize("kind,mode", [
    ("single", "f32"), ("single", "bf16_values"), ("single", "bf16"),
    ("composite", "bf16_values")])
def test_load_applies_cycle_precision(archive, kind, mode):
    ref_h, single, composite = archive
    path = single if kind == "single" else composite
    jax_cfg = JaxSolverConfig(cycle_precision=mode, **KW)
    ref = JaxSolver.load(path, jax_problems.poisson2d(16), jax_cfg)
    # the JAX load casts too: its leaves are the mode's
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(
        ref.preconditioner) if jnp.issubdtype(leaf.dtype, jnp.inexact)} == {
        jnp.dtype(str(DTYPE[mode])[6:])}
    # the values: the uncast JAX load, its banded transfers in ELL, cast
    want_pc = jax_precision.cast_preconditioner(_result_type_transfers(
        JaxSolver.load(path, jax_problems.poisson2d(16),
                       JaxSolverConfig(**KW)).preconditioner), mode)
    lam = reference_lambda_starts(JaxSolver._mg_config(jax_cfg), ref_h)
    got = AMGSolver.load(path, poisson2d(16),
                         SolverConfig(device="cpu", cycle_precision=mode,
                                      **KW),
                         lambda_starts=lam if kind == "single" else [lam] * 2)
    assert got.op.mat.dtype == torch.float64  # uncast
    inner = getattr(got.preconditioner, "inner", got.preconditioner)
    if kind == "composite":
        assert isinstance(inner, Composite) and got.op is not inner.a
        assert inner.a.mat.dtype == DTYPE[mode]
    else:
        assert inner.levels[0].a.mat.dtype == DTYPE[mode]
    for k in (None, 3):
        x = _rhs(256, k, seed=4)
        z = got.apply_preconditioner(x)
        want = want_pc(jnp.asarray(x))
        if mode == "bf16":
            assert _rel(z, want) <= BF16_RTOL
        else:
            _close(z, want)


# ---- (h) the structured V-cycle

@pytest.fixture(scope="module")
def structured(needs_jax):
    from tpu_amg_torch.structured import build_structured_multigrid
    from tpu_amg_torch.utils.problems import poisson3d

    shape = (20, 20, 20)  # DIA, then dense levels
    ref = jax_structured(jax_problems.poisson3d(*shape), shape,
                         coarsest_dim=64, dtype=jnp.float64)
    starts = [np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                           (lvl.a.shape[0],), jnp.float64))
              for lvl in ref.levels]
    got = build_structured_multigrid(poisson3d(*shape), shape, device="cpu",
                                     coarsest_dim=64, dtype=torch.float64,
                                     lambda_starts=starts)
    return ref, got


@pytest.mark.parametrize("mode", ["bf16_values", "bf16"])
def test_structured_cycle_matches_jax(structured, mode, k=3):
    ref, mg = structured
    cast = cast_preconditioner(mg, mode)
    inner = getattr(cast, "inner", cast)
    assert inner.levels[0].p.tentative.weights.dtype == DTYPE[mode]
    assert inner.levels[0].r.inner is inner.levels[0].p  # still shared
    x = _rhs(mg.shape[0], k, seed=6)
    got = cast(torch.from_numpy(x))
    want = jax_precision.cast_preconditioner(ref, mode)(jnp.asarray(x))
    if mode == "bf16":
        assert _rel(got, want) <= BF16_RTOL
    else:
        _close(got, want)


# ---- (i) the kernels' plain versions at the mixed pairs

def _heavy_rows(n=300, m=260, seed=0) -> CSR:
    """Rows of 1-60 entries, so that at cap 16 most spill to K2."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 61, n)
    rows = np.repeat(np.arange(n), deg)
    return CSR.from_coo(rows, rng.integers(0, m, len(rows)),
                        rng.standard_normal(len(rows)), (n, m))


def _jax_csr(csr: CSR):
    return JaxCSR(data=csr.data, indices=csr.indices, indptr=csr.indptr,
                  shape=csr.shape, block_size=csr.block_size)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("value,vector", MIXED)
def test_k1_k2_plain_match_jax_ell(needs_jax, value, vector, k):
    csr = _heavy_rows()
    mat = spmv.CappedCSR.from_csr(csr, "cpu", value, cap=16)
    assert mat.n_tail > 0 and mat.dtype == value
    ell = JaxELL.from_csr(_jax_csr(csr), dtype=jnp.dtype(str(value)[6:]))
    x = _rhs(csr.ncols, None if k == 1 else k, seed=k)
    xt = torch.from_numpy(x).to(vector)
    launches = dict(spmv.csr_spmv_launches_by_dtype)
    got = spmv.spmv(mat, xt)
    want = ell(jnp.asarray(xt.numpy()))
    assert got.dtype == vector and str(want.dtype) == str(vector)[6:]
    _close(got, want, PAIR_TOL[vector])
    assert dict(spmv.csr_spmv_launches_by_dtype) == launches  # plain: uncounted


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("value,vector", MIXED)
def test_k3_plain_matches_jax_dia(needs_jax, value, vector, k):
    csr = anisotropic_diffusion_2d(16, coefficient="random")
    dia = try_from_csr(csr, "cpu", value, max_diags=None)
    ref = jax_try_dia(_jax_csr(csr), dtype=jnp.dtype(str(value)[6:]),
                      max_diags=None)
    np.testing.assert_array_equal(dia.data.float().numpy(),
                                  np.asarray(ref.data, np.float32))
    x = _rhs(csr.nrows, None if k == 1 else k, seed=k)
    xt = torch.from_numpy(x).to(vector)
    got = dia_ops.dia_spmv(dia, xt)
    want = ref(jnp.asarray(xt.numpy()))
    assert got.dtype == vector and str(want.dtype) == str(vector)[6:]
    _close(got, want, PAIR_TOL[vector])


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_sparse_apply_promotes_and_islands(fmt):
    """SparseOperator: bf16 values under bf16 x run as the f32 island (x
    widened, y rounded once); values wider than x widen x; the kernel
    wrappers take only the pairs of spmv.PAIRS."""
    csr = poisson2d(12)
    if fmt == "dia":
        op = SparseOperator.from_csr(csr, "cpu", torch.bfloat16)
        assert hasattr(op.mat, "offsets")
    else:
        op = SparseOperator(mat=spmv.CappedCSR.from_csr(csr, "cpu",
                                                        torch.bfloat16, cap=3))
        assert op.mat.n_tail > 0
    x = torch.from_numpy(_rhs(csr.nrows)).to(torch.bfloat16)
    y = op.mv(x)
    island = op.mv(x.float())
    assert y.dtype == torch.bfloat16 and island.dtype == torch.float32
    assert torch.equal(y, island.to(torch.bfloat16))
    wide = cast_operator(op, torch.float64)
    assert wide.mv(x).dtype == torch.float64
    assert torch.equal(wide.mv(x), wide.mv(x.double()))
    kernel = spmv.spmv if fmt == "csr" else dia_ops.dia_spmv
    with pytest.raises(TypeError, match="no kernel"):
        kernel(wide.mat, x.float())  # values wider than x
    with pytest.raises(TypeError, match="no kernel"):
        kernel(op.mat, x)  # bf16 under bf16: the island's to run


def test_dense_widens_per_apply():
    a = poisson2d(6)
    dense = DenseOperator(mat=torch.from_numpy(a.to_dense()).to(torch.bfloat16))
    x = torch.from_numpy(_rhs(a.nrows))
    y = dense.mv(x)
    assert y.dtype == torch.float64 and dense.mat.dtype == torch.bfloat16
    assert torch.equal(y, dense.mat.double() @ x)


# ---- K3's band tiles with a narrower value stream (restated in numpy)

def _offsets_case(name):
    if name == "adaptive A":
        return (-513, -512, -511, -1, 0, 1, 511, 512, 513), 512 ** 2
    if name == "poisson3d(100)":
        return (-10000, -100, -1, 0, 1, 100, 10000), 100 ** 3
    if name == "160 consecutive":
        return tuple(range(-80, 80)), 3000
    return (-1, 0, 1), 5  # n < T


@pytest.mark.parametrize("k", [8, 33, 64])
@pytest.mark.parametrize("value,vector", MIXED)
@pytest.mark.parametrize("name", ["adaptive A", "poisson3d(100)",
                                  "160 consecutive", "n < T"])
def test_mixed_plan_sizes_each_buffer_by_its_type(name, value, vector, k):
    offsets, n = _offsets_case(name)
    plan = dia_ops.dia_plan(offsets, n, k, vector, SMS, True, value)
    same = dia_ops.dia_plan(offsets, n, k, vector, SMS, True)
    isz = torch.empty((), dtype=vector).element_size()
    vsz = torch.empty((), dtype=value).element_size()
    assert (plan.itemsize, plan.value_itemsize) == (isz, vsz)
    # the launch shape is X's: the value type changes only the buffers
    assert (plan.tile, plan.threads, plan.lanes, plan.vector) == (
        same.tile, same.threads, same.lanes, same.vector)
    stride = plan.data_stride
    assert stride == (((plan.tile + 3) & ~1) if vsz == 2 else plan.tile)
    assert stride >= plan.tile + (vsz == 2) and stride % (2 if vsz == 2 else 1) == 0
    for d0, d1 in plan.bands:
        assert (d1 - d0) * stride <= plan.ds_cap
    assert (plan.xs_cap * isz) % 16 == 0 and (plan.ds_cap * vsz) % 16 == 0
    assert plan.xs_cap * isz <= dia_ops.X_BUDGET
    assert plan.ds_cap * vsz <= dia_ops.DATA_BUDGET
    assert plan.smem_bytes == (2 if len(plan.bands) > 1 else 1) * (
        plan.xs_cap * isz + plan.ds_cap * vsz)
    # the bands: the offsets in order, a data budget of narrower values
    # holds no fewer diagonals
    assert [d for d0, d1 in plan.bands for d in range(d0, d1)] == list(
        range(len(offsets)))
    assert len(plan.bands) <= len(same.bands)


def _stage_bf16_rows(flat, n, d0, nd, i0, rows, stride):
    """The kernel's staging of 2-byte data rows (csrc/dia.cu `stage`):
    4-byte units, row dd's first element at its phase against 4 bytes
    in a slot of ``stride``; NaN where nothing was copied."""
    ds = np.full(nd * stride, np.nan)
    for dd in range(nd):
        at = (d0 + dd) * n + i0
        ph = at & 1
        for u in range((rows + 2) // 2):
            first = 2 * u - ph
            if first < rows:
                assert 2 * u + 1 < stride  # inside the row's slot
                ds[dd * stride + 2 * u] = flat[at + first]
                ds[dd * stride + 2 * u + 1] = (flat[at + first + 1]
                                               if first + 1 < rows else 0.0)
    return ds


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("name", ["aniso16", "160 consecutive"])
def test_bf16_row_staging_sum_matches_plain(name, k):
    rng = np.random.default_rng(3)
    if name == "aniso16":
        dia = try_from_csr(anisotropic_diffusion_2d(16, coefficient="random"),
                           "cpu", torch.bfloat16, max_diags=None)
    else:
        from tpu_amg_torch.sparse.dia import dia_from_arrays

        n = 301  # odd: rows start at both phases
        dia = dia_from_arrays(rng.standard_normal((160, n)),
                              tuple(range(-80, 80)), (n, n), 160 * n, "cpu",
                              torch.bfloat16)
    n = dia.shape[0]
    plan = dia_ops.dia_plan(dia.offsets, n, k, torch.float64, 4 * SMS, True,
                            torch.bfloat16)
    flat = dia.data.double().numpy().ravel()
    x = rng.standard_normal((n, k))
    y = np.zeros((n, k))
    for blk in range(plan.blocks):
        i0 = blk * plan.tile
        rows = min(plan.tile, n - i0)
        for d0, d1 in plan.bands:
            ds = _stage_bf16_rows(flat, n, d0, d1 - d0, i0, rows,
                                  plan.data_stride)
            for d in range(d0, d1):
                row = np.arange(rows)
                src = i0 + row + plan.offsets[d]
                ok = (src >= 0) & (src < n)
                ph = (d * n + i0) & 1
                a = ds[(d - d0) * plan.data_stride + ph + row[ok]]
                assert np.isfinite(a).all()
                y[i0 + row[ok]] += a[:, None] * x[src[ok]]
    ref = dia_ops.plain_dia_spmv(dia, torch.from_numpy(x))
    _close(torch.from_numpy(y), ref.numpy(), 1e-12)


# ---- (j) on the card: each kernel at each pair against its plain version

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("value,vector", MIXED)
def test_k1_k2_pairs_on_card(cuda, value, vector, k):
    csr = _heavy_rows(3000, 2500)
    mat = spmv.CappedCSR.from_csr(csr, cuda, value, cap=16)
    x = torch.from_numpy(_rhs(csr.ncols, None if k == 1 else k, seed=k)).to(
        cuda, vector)
    before = spmv.csr_spmv_launches_by_dtype[(value, vector)]
    before2 = spmv.coo_patch_launches_by_dtype[(value, vector)]
    y, again = spmv.spmv(mat, x), spmv.spmv(mat, x)
    ref = spmv.plain_spmv(mat, x)
    torch.cuda.synchronize()
    assert y.dtype == vector and torch.equal(y, again)
    assert spmv.csr_spmv_launches_by_dtype[(value, vector)] == before + 2
    assert spmv.coo_patch_launches_by_dtype[(value, vector)] == before2 + 2
    assert float((y - ref).abs().max()) <= CARD_TOL[vector] * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 8, 64])
@pytest.mark.parametrize("value,vector", MIXED)
@pytest.mark.parametrize("n", [256, 301])
def test_k3_pairs_on_card(cuda, value, vector, k, n):
    from tpu_amg_torch.sparse.dia import dia_from_arrays

    rng = np.random.default_rng(n)
    offsets = (-17, -16, -15, -1, 0, 1, 15, 16, 17)
    dia = dia_from_arrays(rng.standard_normal((9, n)), offsets, (n, n),
                          9 * n, cuda, value)
    x = torch.from_numpy(_rhs(n, None if k == 1 else k, seed=k)).to(
        cuda, vector)
    before = dia_ops.dia_spmv_launches_by_dtype[(value, vector)]
    y, again = dia_ops.dia_spmv(dia, x), dia_ops.dia_spmv(dia, x)
    first = dia_ops.launch_first_design(dia, x)
    tiles = dia_ops.launch_band_tiles(dia, x)
    ref = dia_ops.plain_dia_spmv(dia, x)
    torch.cuda.synchronize()
    assert y.dtype == vector and torch.equal(y, again)
    assert torch.equal(first, tiles)  # the two designs: the same bits
    assert dia_ops.dia_spmv_launches_by_dtype[(value, vector)] == before + 2
    assert float((y - ref).abs().max()) <= CARD_TOL[vector] * float(
        ref.abs().max())


@pytest.mark.cuda
def test_unsupported_pair_raises_on_card(cuda):
    mat = spmv.CappedCSR.from_csr(poisson2d(8), cuda, torch.float64)
    with pytest.raises(TypeError, match="no kernel"):
        spmv.csr_spmv_capped(mat, torch.ones(64, device=cuda))
