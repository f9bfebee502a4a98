"""The one traffic generator.  A mix is a JSON file of parameters,
``amgbench/traffic/<mix>.json``:

- ``pool``: how many right-hand sides the run makes in its set-up, each
  b = A x_true with x_true ~ N(0, 1); the solves of the window take them
  in order, round and round (a closed loop of one client);
- ``x0``: "zero", each solve starts from 0;
- ``rtol``: the relative residual each solve is asked for;
- ``checked``: how many of the window's solves the check judges, a
  sample drawn from the seed (:func:`amgbench.run.run_window`), besides
  the slowest.

b = A x_true is made on the device in float64 with plain PyTorch from the
benchmark's CSR arrays, then cast to the configuration's dtype.  The
draws come from a ``torch.Generator`` on the device seeded with
``--seed``: the same seed gives the same right-hand sides, and every
seed the same sizes and order.
"""

from __future__ import annotations

import dataclasses

import torch

X0_KINDS = ("zero",)


@dataclasses.dataclass
class Pool:
    b: torch.Tensor  # (pool, n), each row a right-hand side
    checked: int  # how many solves of the window the check judges


def device_matrix(problem: dict, device) -> torch.Tensor:
    """A as a float64 sparse CSR tensor on ``device``."""
    n = len(problem["indptr"]) - 1
    return torch.sparse_csr_tensor(
        torch.as_tensor(problem["indptr"]).to(device),
        torch.as_tensor(problem["indices"]).to(device, torch.int64),
        torch.as_tensor(problem["data"]).to(device, torch.float64),
        size=(n, n))


def make_pool(mix: dict, problem: dict, seed: int, dtype: torch.dtype,
              device) -> Pool:
    if mix["x0"] not in X0_KINDS:
        raise ValueError(f"x0 {mix['x0']!r} is none of {X0_KINDS}")
    n = len(problem["indptr"]) - 1
    size = int(mix["pool"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    a = device_matrix(problem, device)
    b = torch.empty(size, n, dtype=dtype, device=device)
    # in blocks of rows, so that the float64 draws stay small beside b
    block = 8
    for k in range(0, size, block):
        xs = torch.randn(min(block, size - k), n, generator=g,
                         dtype=torch.float64, device=device)
        b[k:k + xs.shape[0]] = (a @ xs.T.contiguous()).T.to(dtype)
    return Pool(b=b, checked=int(mix["checked"]))
