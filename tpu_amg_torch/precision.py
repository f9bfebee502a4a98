"""Mixed-precision cycles: a built preconditioner evaluated in a narrower
dtype.  Port of ``tpu_amg/precision.py``.

Every apply of the V-cycle is bound by bytes, and most of those bytes
are operator values: matrix values, smoother diagonals and inverses,
transfer weights, the dense coarse inverse.  The preconditioner stays a
fixed linear operator whatever precision it is evaluated in, so a
narrower cycle perturbs PCG only through the quality of M as an
approximation of A⁻¹.  The outer Krylov loop (residuals, dots, AXPYs)
keeps the caller's dtype.  What a mode saves on the H100 is measured by
``chip_smoke.py`` (PERF.md), not assumed.

Modes (:func:`cast_preconditioner`, ``SolverConfig.cycle_precision``,
``tools.amg --precision``), the JAX package's set:

- ``None`` / ``"none"``: the preconditioner as built.
- ``"f64"``, ``"f32"``: every floating-point array of the operator tree
  cast to that dtype; vectors keep theirs.
- ``"bf16_values"``: the arrays cast to bfloat16; vectors keep theirs.
- ``"bf16"``: the arrays cast to bfloat16 and the cycle wrapped in
  :class:`MixedPrecision`, so that its vectors are bfloat16 too.

Every apply computes and returns in ``torch.promote_types(value dtype,
vector dtype)``, the ``jnp.result_type`` rule of the JAX formats
(``sparse/dia.py:89``, ``sparse/ell.py:159``): a bf16 value stream under
f64 vectors is widened exactly and summed in f64.  The sparse kernels
(K1 + K2, K3) do that widening per entry on the card; ``torch.matmul``
and ``torch.bmm`` take one dtype, so dense levels, coarse inverses and
block inverses are widened per apply (``linop.matmul``), as XLA converts
``jnp.dot(bf16, f64)``.  No wide copy is kept: it would undo the mode.

**The f32 island.**  Where the values and the vectors are both bf16
(``"bf16"`` mode), a sparse apply widens x to f32, runs the (bf16, f32)
kernels and rounds y to bf16 once, after K2 has added the tail
(``linop._apply``).  That is ``_F32Island`` (``tpu_amg/precision.py``),
which the TPU runs for its WELL SpMV: its K1 takes a bf16 value stream
and computes in its vectors' dtype, f32 (``well_pallas.py:112``).  On
the card it keeps K1 + K2 to one rounding and needs no bf16-vector
kernel.  The JAX package's CPU formats (ELL, DIA) instead sum in bf16,
so in ``"bf16"`` mode the port agrees with the JAX package only to
bf16's tolerance.  Dense levels and block inverses stay bf16 × bf16
through ``torch.matmul`` / ``torch.bmm``, as the JAX package computes
them outside any Pallas kernel.

The cast walks the port's operator dataclasses field by field, as the
JAX cast walks its pytree, and casts the same leaves: tensors of a
floating dtype, and the three scalars that the port keeps as Python
floats where the JAX package keeps arrays (``ChebyshevSmoother.lam_max``
and ``lam_min``, ``ScaledIdentity.scale``), which become 0-d tensors of
the mode's dtype on the host (so a CUDA graph captures them as the
launch arguments they are).  Integer and bool tensors (indices, row
tables) and static fields are kept.  An ``ELL`` or a ``BSR`` is cast
by its ``astype``: its padded values and the capped CSR that applies
them together, so the two cannot drift apart.  An operator reached twice (a
level's A is also its smoother's and its smoothed transfer's) is cast
once and stays shared.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from tpu_amg_torch.linop import LinearOperator
from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.ell import ELL

MODES = (None, "none", "f64", "f32", "bf16_values", "bf16")


def _cast(op: Any, dtype: torch.dtype, memo: dict) -> Any:
    if op is None or isinstance(op, (bool, int, str, bytes, type)):
        return op
    if isinstance(op, float):
        return torch.tensor(op, dtype=dtype)
    key = id(op)
    if key in memo:
        return memo[key]
    if isinstance(op, torch.Tensor):
        out = op.to(dtype) if op.is_floating_point() else op
    elif isinstance(op, (ELL, BSR)):
        out = op.astype(dtype)
    elif dataclasses.is_dataclass(op) and not isinstance(op, type):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            nv = _cast(v, dtype, memo)
            if nv is not v:
                changes[f.name] = nv
        out = dataclasses.replace(op, **changes) if changes else op
    elif isinstance(op, tuple):
        out = type(op)(_cast(v, dtype, memo) for v in op)
    elif isinstance(op, list):
        out = [_cast(v, dtype, memo) for v in op]
    elif isinstance(op, dict):
        out = {k: _cast(v, dtype, memo) for k, v in op.items()}
    else:
        out = op
    memo[key] = out
    return out


def cast_operator(op: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """``op`` with every floating-point tensor of its tree cast to
    ``dtype``, and its Python-float scalars made 0-d tensors of
    ``dtype``; integer and bool tensors and static fields untouched."""
    return _cast(op, dtype, {})


@dataclasses.dataclass
class MixedPrecision(LinearOperator):
    """Evaluates ``inner`` in ``compute_dtype`` and returns results in
    the input's dtype: the precision boundary that keeps the outer
    Krylov loop's vectors in full precision."""

    inner: LinearOperator
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self):
        return self.inner.shape

    def mv(self, x):
        return self.inner.mv(x.to(self.compute_dtype)).to(x.dtype)

    def mm(self, xs):
        return self.inner.mm(xs.to(self.compute_dtype)).to(xs.dtype)


def cast_preconditioner(pc: LinearOperator,
                        mode: Optional[str]) -> LinearOperator:
    """Apply a precision mode (``MODES``) to a built preconditioner:
    ``"f32"`` / ``"f64"`` cast its arrays to that dtype, ``"bf16_values"``
    to bfloat16, ``"bf16"`` to bfloat16 inside :class:`MixedPrecision`;
    None / ``"none"`` return it as it is.  Any other mode raises
    ``ValueError``."""
    if mode in (None, "none"):
        return pc
    if mode in ("f32", "f64"):
        return cast_operator(
            pc, torch.float32 if mode == "f32" else torch.float64)
    if mode == "bf16_values":
        return cast_operator(pc, torch.bfloat16)
    if mode == "bf16":
        return MixedPrecision(inner=cast_operator(pc, torch.bfloat16),
                              compute_dtype=torch.bfloat16)
    raise ValueError(f"unknown precision mode {mode!r} (one of {MODES})")
