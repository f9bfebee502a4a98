"""The compiled solve (``AMGSolver.compile``): one iteration captured in
a CUDA graph and replayed, against the eager solve; with an SA V-cycle
and with the adaptive composite.

On the card the compiled PCG and stationary solves give the eager
solves' iterations and histories and, bit for bit, their x; a replay
adds the captured launches to the kernels' counts.  On the CPU the
compiled function is the eager solve, and the count arithmetic is
checked on its own.  This file imports no JAX, so that it runs on the
card's machine.
"""

import collections

import numpy as np
import pytest
import torch

from tpu_amg_torch.ops import dia, spmv
from tpu_amg_torch.linop import SparseOperator
from tpu_amg_torch.preconditioners import Composite
from tpu_amg_torch.solver import AMGSolver, SolverConfig, scalar_3d_config
from tpu_amg_torch.solvers import cg, graph, stationary_iteration
from tpu_amg_torch.utils.problems import (
    anisotropic_diffusion_2d,
    unstructured_poisson_3d,
)

EAGER = {"cg": cg, "stationary": stationary_iteration}


def _reset():
    spmv.reset_launch_counts()
    dia.reset_launch_counts()


def test_count_replays_adds_the_captured_launches():
    _reset()
    before = graph.launch_counts()
    spmv.csr_spmv_launches += 3
    spmv.csr_spmv_launches_by_shape[(5, 5, 1)] += 2
    spmv.csr_spmv_launches_by_shape[(5, 4, 1)] += 1
    spmv.coo_patch_launches += 1
    spmv.coo_patch_launches_by_shape[(5, 5, 1)] += 1
    dia.dia_spmv_launches += 2
    captured = graph.counts_between(before, graph.launch_counts())
    assert (captured["csr_spmv_launches"], captured["coo_patch_launches"],
            captured["dia_spmv_launches"]) == (3, 1, 2)
    graph.count_replays(captured, 4)
    assert (spmv.csr_spmv_launches, spmv.coo_patch_launches,
            dia.dia_spmv_launches) == (15, 5, 10)
    assert spmv.csr_spmv_launches_by_shape == collections.Counter(
        {(5, 5, 1): 10, (5, 4, 1): 5})
    assert spmv.coo_patch_launches_by_shape == collections.Counter(
        {(5, 5, 1): 5})
    # a negative count takes launches back out, shapes at 0 included
    graph.count_replays(captured, -5)
    assert graph.launch_counts() == before
    assert not spmv.csr_spmv_launches_by_shape
    _reset()


def _small_solver(device):
    a = unstructured_poisson_3d(11)
    cfg = scalar_3d_config(device, coarsest_dim=40, dense_threshold=50)
    b = a.to_scipy() @ np.random.default_rng(5).standard_normal(a.nrows)
    return AMGSolver.setup(a, cfg), b


@pytest.mark.parametrize("method", list(EAGER))
def test_compile_on_cpu_is_the_eager_solve(method):
    solver, b = _small_solver("cpu")
    fn = solver.compile(rtol=1e-6, maxiter=200, method=method)
    x, info = fn(torch.from_numpy(b))
    x_e, info_e = EAGER[method](solver.op, torch.from_numpy(b),
                                  solver.preconditioner, rtol=1e-6,
                                  maxiter=200)
    assert not solver._graphs
    assert info.converged and info.iters == info_e.iters
    assert info.history().tolist() == info_e.history().tolist()
    assert torch.equal(x, x_e)


@pytest.fixture(scope="module")
def card_solver():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _small_solver("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(EAGER))
def test_graph_solve_is_the_eager_solve_on_card(card_solver, method):
    solver, b_np = card_solver
    b = torch.from_numpy(b_np).cuda()
    x0 = torch.from_numpy(
        np.random.default_rng(6).standard_normal(len(b_np))).cuda()
    fn = solver.compile(rtol=1e-6, maxiter=200, method=method)
    for start in (None, x0):  # the second solve replays the cached graph
        x_e, info_e = EAGER[method](solver.op, b, solver.preconditioner,
                                      start, rtol=1e-6, maxiter=200)
        x, info = fn(b, start)
        assert info.converged and info.iters == info_e.iters > 0
        assert info.history().tolist() == info_e.history().tolist()
        assert torch.equal(x, x_e)
    assert len([k for k in solver._graphs if k[0] == method]) == 1


def _times(counts: dict, n: int) -> dict:
    """``n`` × a snapshot of launch counts."""
    return {name: (collections.Counter({key: n * v for key, v in c.items()})
                   if isinstance(c, collections.Counter) else n * c)
            for name, c in counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(EAGER))
def test_replays_are_counted_on_card(card_solver, method):
    solver, b_np = card_solver
    b = torch.from_numpy(b_np).cuda()
    fn = solver.compile(rtol=1e-6, maxiter=200, method=method)
    solver._graphs.clear()  # so that the first compiled solve captures
    counts = {}
    for name, solve in (("eager", lambda: EAGER[method](
            solver.op, b, solver.preconditioner, rtol=1e-6, maxiter=200)),
                        ("capture", lambda: fn(b)), ("graph", lambda: fn(b))):
        torch.cuda.synchronize()
        _reset()
        _, info = solve()
        counts[name] = (graph.launch_counts(), info.iters)
    (eager, k_e), (first, k_c), (replayed, k_g) = counts.values()
    assert k_e == k_c == k_g > 0
    # the same kernels, launched as often, by shape too
    assert eager == replayed and eager["csr_spmv_launches"] > 0
    # the capturing solve counts its warm-up steps, which launch, and
    # not the capture, which launches nothing
    step = solver._graphs[(method, len(b_np), torch.float64)].captured
    assert step["csr_spmv_launches"] > 0
    assert graph.counts_between(eager, first) == _times(step,
                                                        graph.WARMUP_STEPS)


# ---- the adaptive composite: the card against the CPU, compiled against
# eager

ADAPTIVE = dict(method="adaptive", composite_components=2,
                coarsening_near_null_dim=8, smoothing_iters=10,
                coarsest_dim=40, dense_threshold=50, smoother="block",
                smoothing_steps=3)


def _composite_solver(device):
    a = anisotropic_diffusion_2d(24, coefficient="random")
    b = a.to_scipy() @ np.random.default_rng(5).standard_normal(a.nrows)
    return AMGSolver.setup(a, SolverConfig(device=device, **ADAPTIVE)), b


def _cpu_twin(solver):
    """The same hierarchies built into a composite on the CPU (the
    kernels' plain versions)."""
    cfg = SolverConfig(device="cpu", **ADAPTIVE)
    return Composite.from_hierarchies(solver.matrix,
                                      solver.component_hierarchies,
                                      AMGSolver._mg_config(cfg))


@pytest.mark.parametrize("method", list(EAGER))
def test_composite_compile_on_cpu_is_the_eager_solve(method):
    solver, b = _composite_solver("cpu")
    x, info = solver.solve(b, rtol=1e-8, maxiter=200, method=method)
    x_e, info_e = EAGER[method](solver.op, torch.from_numpy(b),
                                  solver.preconditioner, rtol=1e-8,
                                  maxiter=200)
    assert info.converged and info.iters == info_e.iters
    assert torch.equal(x, x_e)


@pytest.fixture(scope="module")
def card_composite():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _composite_solver("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 5])
def test_composite_on_card_matches_plain(card_composite, k):
    solver, b = card_composite
    twin = _cpu_twin(solver)
    x = np.random.default_rng(3).standard_normal(
        (len(b),) if k is None else (len(b), k))
    _reset()
    got = solver.preconditioner(torch.from_numpy(x).cuda()).cpu()
    assert spmv.csr_spmv_launches + dia.dia_spmv_launches > 0
    want = twin(torch.from_numpy(x))
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(EAGER))
def test_composite_graph_solve_is_the_eager_solve(card_composite, method):
    solver, b_np = card_composite
    b = torch.from_numpy(b_np).cuda()
    fn = solver.compile(rtol=1e-8, maxiter=300, method=method)
    for _ in range(2):  # the second solve replays the cached graph
        x_e, info_e = EAGER[method](solver.op, b, solver.preconditioner,
                                      rtol=1e-8, maxiter=300)
        x, info = fn(b)
        assert info.iters == info_e.iters > 0
        assert info.history().tolist() == info_e.history().tolist()
        assert torch.equal(x, x_e)
    if method == "cg":
        assert info.converged
