"""Host sparse container (:class:`CSR`), the device formats
(:class:`DIA` through K3; :class:`ELL` and :class:`BSR` through K1 +
K2), and setup-time sparse algebra."""

from tpu_amg_torch.sparse.bsr import BSR
from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.sparse.ell import ELL
from tpu_amg_torch.sparse.ops import (diags_csr, eye_csr, from_coo, rap,
                                      sp_add, sp_transpose, spgemm)

__all__ = ["BSR", "CSR", "DIA", "ELL", "spgemm", "rap", "sp_add",
           "sp_transpose", "from_coo", "eye_csr", "diags_csr"]
