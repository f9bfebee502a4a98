"""The plain reference: what decides ``correct``.

It works from the benchmark's own inputs (the CSR arrays a generator
made, the right-hand sides the traffic made) and reads the program's
outputs (x and the residual its loop reported) only to judge them.  It
imports NumPy and SciPy, and nothing of the program.

The guarantee a configuration states: the solve returns x with
‖b − A x‖₂ ≤ rtol · ‖b‖₂, where A and b are the inputs in the
configuration's dtype, up to the rounding of one evaluation of b − A x in
that dtype, m · u · ‖|A| |x|‖₂ (m the longest row, u the unit roundoff).
Two numbers per checked solve, the worst of each over the solves:

- ``residual_ratio``: the true relative residual, taken in float64, over
  rtol plus that rounding; the configuration's limit is 1;
- ``claim_gap``: |true − reported relative residual| / rtol, where the
  reported one is the program's own ``final_res`` over ‖b‖₂: how far the
  residual the solve reports is from the one its x has.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps

UNIT_ROUNDOFF = {"float64": 2.0 ** -53, "float32": 2.0 ** -24}


def host_matrix(problem: dict, dtype: str) -> sps.csr_matrix:
    """A with its values rounded to ``dtype`` and held in float64."""
    n = len(problem["indptr"]) - 1
    data = np.asarray(problem["data"]).astype(dtype).astype(np.float64)
    return sps.csr_matrix((data, problem["indices"], problem["indptr"]),
                          shape=(n, n))


@dataclasses.dataclass
class Checker:
    """Judges solves of one problem in one dtype at one rtol."""

    a: sps.csr_matrix
    abs_a: sps.csr_matrix
    longest_row: int
    unit_roundoff: float
    rtol: float

    @staticmethod
    def build(problem: dict, dtype: str, rtol: float) -> "Checker":
        a = host_matrix(problem, dtype)
        abs_a = a.copy()
        abs_a.data = np.abs(abs_a.data)
        return Checker(a=a, abs_a=abs_a,
                       longest_row=int(np.diff(a.indptr).max()),
                       unit_roundoff=UNIT_ROUNDOFF[dtype], rtol=rtol)

    def numbers(self, b: np.ndarray, x: np.ndarray, reported: float) -> dict:
        """One solve's numbers: b as the program got it, x as it returned
        it (both widened to float64), ``reported`` its final ‖r‖₂."""
        b = np.asarray(b, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        nb = float(np.linalg.norm(b))
        true = float(np.linalg.norm(b - self.a @ x)) / nb
        if not np.isfinite(true):
            true = float("inf")
        rounding = (self.longest_row * self.unit_roundoff
                    * float(np.linalg.norm(self.abs_a @ np.abs(x))) / nb)
        gap = abs(true - float(reported) / nb) / self.rtol
        return dict(true_res=true, rounding=rounding,
                    residual_ratio=true / (self.rtol + rounding),
                    claim_gap=gap if np.isfinite(gap) else float("inf"))


def worst(per_solve: list) -> dict:
    """The largest of each number over the checked solves."""
    return {key: max(s[key] for s in per_solve)
            for key in ("residual_ratio", "claim_gap")}


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
