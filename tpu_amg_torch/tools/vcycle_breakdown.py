"""Per-level, per-component V-cycle attribution: the port of the JAX
package's ``tools/vcycle_breakdown.py``.

:func:`breakdown` times, for each level of an in-memory
:class:`~tpu_amg_torch.preconditioners.multigrid.Multigrid`, the level's
A apply, smoother apply, P and R, then the coarse solve and the full
cycle, and sums the components the way the cycle runs them: per level
``2·steps·S + (2·steps + 1)·A + P + R`` (each pre- and post-smoothing
step is one smoother apply and one residual A·x, plus the residual
before restriction; the coarsest level adds the coarse solve).  The
port's cycle computes the pre-smoother's A·0 too, so the count is exact
here.  For a :class:`~tpu_amg_torch.preconditioners.composite.Composite`
every member multigrid is attributed, and the composite's own sweep is
estimated from them: n components cost 2n − 1 member applies (the first
member once, every other twice) and 2n − 2 applies of A.

Each time is the device's: CUDA events around the replay of a CUDA graph
of ``reps`` applies, the median of 5 (:func:`tpu_amg_torch.utils.timing.call_ms`);
on the CPU the host clock (a CPU number).

The command line loads a checkpoint of the 3-D hierarchy
(``tools.setup3d``) as the JAX tool does, with ``--device`` added
(default "cuda"), and prints the JAX tool's lines.

Usage: python -m tpu_amg_torch.tools.vcycle_breakdown --ckpt H.npz [--side 101] [--elasticity] [--reps 50] [--device cpu]
"""

import argparse
import dataclasses
import sys

import torch

from tpu_amg_torch.utils.timing import call_ms


def _first_tensor(op):
    """The first floating-point tensor of an operator's tree."""
    if isinstance(op, torch.Tensor):
        return op if op.is_floating_point() else None
    if dataclasses.is_dataclass(op) and not isinstance(op, type):
        for f in dataclasses.fields(op):
            t = _first_tensor(getattr(op, f.name))
            if t is not None:
                return t
    if isinstance(op, (tuple, list)):
        for v in op:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def level_format(a_op) -> str:
    """A level operator's storage: the sparse format (``CappedCSR``,
    ``DIA``) or the operator's class."""
    mat = getattr(a_op, "mat", None)
    if mat is not None and not isinstance(mat, torch.Tensor):
        return type(mat).__name__
    return type(a_op).__name__


def cycle_sum_ms(levels, steps: int, coarse_ms: float) -> float:
    """The sum of components of one V-cycle from per-level times (dicts
    with ``a_ms``, ``smoother_ms``, ``p_ms``, ``r_ms``, ``has_p``)."""
    total = coarse_ms
    for lv in levels:
        total += 2 * steps * lv["smoother_ms"]
        if lv["has_p"]:
            total += ((2 * steps + 1) * lv["a_ms"] + lv["p_ms"]
                      + lv["r_ms"])
    return total


def _multigrid(mg, reps: int, device, dtype, say) -> dict:
    def timed(op, n):
        x = torch.ones(n, dtype=dtype, device=device)
        return call_ms(lambda: op(x), device, reps)

    steps = mg.smoothing_steps
    levels = []
    for i, lvl in enumerate(mg.levels):
        n = lvl.a.shape[0]
        t_a = timed(lvl.a, n)
        t_s = timed(lvl.smoother, n)
        t_p = t_r = 0.0
        if lvl.p is not None:
            t_p = timed(lvl.p, lvl.p.shape[1])
            t_r = timed(lvl.r, n)
        fmt = level_format(lvl.a)
        levels.append(dict(level=i, n=n, fmt=fmt, a_ms=t_a, smoother_ms=t_s,
                           p_ms=t_p, r_ms=t_r, has_p=lvl.p is not None))
        say(f"# level {i} n={n} fmt={fmt}: A.mv {t_a:8.3f}ms  "
            f"smoother {t_s:8.3f}ms  P {t_p:8.3f}ms  R {t_r:8.3f}ms")
    cs = mg.coarse_solver
    n_c = cs.shape[0]
    t_c = timed(cs, n_c)
    say(f"# coarse solve n={n_c}: {t_c:.3f}ms")
    total = cycle_sum_ms(levels, steps, t_c)
    t_full = timed(mg, mg.shape[0])
    say(f"# sum-of-components estimate {total:.2f}ms vs full "
        f"V-cycle {t_full:.2f}ms")
    return dict(levels=levels, steps=steps, coarse=dict(n=n_c, ms=t_c),
                sum_ms=total, full_ms=t_full)


def breakdown(mg, reps: int, say=print) -> dict:
    """The attribution of ``mg`` (a Multigrid, or a Composite of them):
    per-level times, the coarse solve, the sum of components and the
    full apply, in ms.  Vectors take the device and dtype of the
    operator's first floating tensor (bf16 values are applied to float32
    vectors)."""
    from tpu_amg_torch.preconditioners.composite import Composite

    t = _first_tensor(mg)
    device = t.device
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    if not isinstance(mg, Composite):
        return _multigrid(mg, reps, device, dtype, say)
    members = mg.components
    say(f"# composite preconditioner with {len(members)} components; "
        "attributing each")
    comps = []
    for c, member in enumerate(members):
        say(f"# component {c}")
        comps.append(_multigrid(member, reps, device, dtype, say))
    x = torch.ones(mg.shape[0], dtype=dtype, device=device)
    t_a = call_ms(lambda: mg.a(x), device, reps)
    runs = [1] + [2] * (len(members) - 1)  # the sweep: first once
    total = (sum(r * c["sum_ms"] for r, c in zip(runs, comps))
             + (2 * len(members) - 2) * t_a)
    t_full = call_ms(lambda: mg(x), device, reps)
    say(f"# composite A.mv {t_a:.3f}ms; sum-of-components estimate "
        f"{total:.2f}ms vs full composite {t_full:.2f}ms")
    return dict(components=comps, runs=runs, a_ms=t_a, sum_ms=total,
                full_ms=t_full)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=101)
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--elasticity", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from tpu_amg_torch.solver import AMGSolver, SolverConfig
    from tpu_amg_torch.utils.problems import (
        unstructured_elasticity_3d,
        unstructured_poisson_3d,
    )

    cfg = SolverConfig(dtype=torch.float32, dense_threshold=8192,
                       smoothing_steps=1, device=args.device)
    a = (unstructured_elasticity_3d(args.side) if args.elasticity
         else unstructured_poisson_3d(args.side))
    solver = AMGSolver.load(args.ckpt, a, cfg)
    breakdown(solver.preconditioner, args.reps,
              say=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
