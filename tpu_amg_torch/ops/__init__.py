"""Kernels and native host code: the K1/K2 sparse apply (``spmv``), the
K3 DIA apply (``dia``), the stream-bandwidth probe (``stream``), the
C++ setup kernels (``native``) and tall-skinny QR (``qr``)."""
