"""Host sparse container (:class:`CSR`), the device DIA format
(:class:`DIA`), and setup-time sparse algebra."""

from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.dia import DIA
from tpu_amg_torch.sparse.ops import from_coo, rap, sp_add, spgemm

__all__ = ["CSR", "DIA", "from_coo", "rap", "sp_add", "spgemm"]
