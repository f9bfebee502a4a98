"""The comparison that decides ``correct``, shown to fail.

At small sizes on the CPU (the harness's look for a card skipped, the
rest of a run driven through :func:`amgbench.run.run_cell`): the program
passes; each configuration's lower-precision control fails; and so does
the program with its timed path broken underneath, once for each fault a
solve can have (a step that returns its state unchanged; the operator's
apply computing half the rows, the rest left out; an answer altered
where it is produced).  On the card the same control runs at the cells'
own sizes with ``python -m amgbench.control`` (``PERF.md``).
"""

import sys
from pathlib import Path

import pytest
import torch

from amgbench import control, run

REPO = Path(__file__).resolve().parents[2]
# the cells at sizes a test run holds: each keeps at least one level of
# its hierarchy above the coarse solve
SMALL = {"poisson3d_7pt_200.cold": {"n": 12},
         "mfem_ex1p_tri.cold": {"max_serial_elements": 512}}
SEED = 2 ** 31 + 11
SECONDS = 0.5


def small_cell(name):
    cell = run.load_cell(REPO / "BENCHMARK.json", name)
    cell.config.update(SMALL[name])
    return cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_is_correct(name):
    result = run.run_cell(small_cell(name), SEED, SECONDS, False, "cpu")
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    cell = small_cell(name)

    def build(problem, config, device):
        return control.control_solver(config, problem, device)

    result = run.run_cell(cell, SEED, SECONDS, False, "cpu", build=build)
    assert not result["correct"], result["compared"]


def _cg_module():
    return sys.modules["tpu_amg_torch.solvers.cg"]


def fault_unchanged_state(monkeypatch):
    cg = _cg_module()
    monkeypatch.setattr(
        cg, "cg_step",
        lambda a, m=None, flexible=False: lambda s: (s, cg.snorm(s[1])))


def half_the_rows(solver):
    """The solver with its operator's apply computing only the first half
    of the rows, the rest left out (zero)."""
    full = solver.op.mv

    def mv(x):
        y = full(x).clone()
        y[y.shape[0] // 2:] = 0
        return y

    solver.op.mv = mv
    return solver


class Altered:
    """The program's solver with one entry of each answer changed."""

    def __init__(self, solver):
        self.solver = solver

    def solve(self, b, x0=None, *, rtol, maxiter):
        x, info = self.solver.solve(b, x0, rtol=rtol, maxiter=maxiter)
        x = x.clone()
        x[x.shape[0] // 3] += 1.0
        return x, info


# each fault: patched into the program's modules, or wrapped around the
# solver the preset builds
FAULTS = {"unchanged_state": (fault_unchanged_state, None),
          "half_the_rows": (None, half_the_rows),
          "answer_altered": (None, Altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    patch, wrap = FAULTS[fault]
    build = None
    if patch is not None:
        patch(monkeypatch)
    else:
        preset = run.module("presets", cell.config["preset"]).build

        def build(problem, config, device):
            return wrap(preset(problem, config, device))
    result = run.run_cell(cell, SEED, SECONDS, False, "cpu", build=build)
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run.run_cell(small_cell(name), SEED, 2.0, True, "cuda")
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert result["breakdown"]["device_ops"]
    assert 0 < result["metrics"]["fine_spmv_roofline"]["value"] <= 105
