"""Host sparse container (:class:`CSR`) and setup-time sparse algebra."""

from tpu_amg_torch.sparse.csr import CSR
from tpu_amg_torch.sparse.ops import from_coo, rap, sp_add, spgemm

__all__ = ["CSR", "from_coo", "rap", "sp_add", "spgemm"]
