"""Kernels and native host code: the K1/K2 sparse apply (``spmv``), the
C++ setup kernels (``native``) and tall-skinny QR (``qr``)."""
