"""Dense/randomized decompositions."""

from tpu_amg_torch.decompositions.rand_svd import (
    rand_svd,
    smooth_vector_rand_svd,
)

__all__ = ["rand_svd", "smooth_vector_rand_svd"]
