// DIA (diagonal-format) sparse matrix-vector / matrix-multivector kernel
// for Hopper (sm_90a).
//
//   K3 dia_spmv  Y[i, :] = sum_d data[d, i] * X[i + off_d, :]
//                Replaces the DIA SpMV Pallas kernel
//                (tpu_amg/ops/dia_pallas.py `_kernel`), and with it the
//                XLA slice-FMA apply of tpu_amg/sparse/dia.py that the JAX
//                package runs on its solve path.
//
// It keeps the contract (y = A x, and Y = A X for a row-major (n, k) X;
// square A, any n, up to a few hundred diagonals) and drops the TPU
// layout: the tile multiple of n, the VMEM cap on x, the 128-lane
// aligned slabs and static rotates existed only for Mosaic.  There is
// no padded copy of x either: a read i + off_d outside [0, n) is skipped,
// since its data entry is a structural zero.
//
// Bound by bytes: per diagonal a value and an x element for 2 flops, no
// index stream (the 4-byte column index of CSR is what DIA saves).  This
// first version is simple: one thread per (row, column) pair; a thread
// walks the diagonals in offset order (the JAX package's summation order)
// and accumulates in the value type.  Reads of data[d, i] and of
// X[i + off_d, c] are coalesced across a warp; the neighbouring
// diagonals' x reads hit in L1/L2.  The offsets live in a device array
// owned by the matrix and are passed by pointer, so two operators with
// different offsets can share a stream and a CUDA graph.
//
// The host side (tpu_amg_torch/ops/dia.py) allocates the output, passes
// PyTorch's current stream and checks the returned cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_kernel(int64_t n, int n_diags, int k,
                           const int64_t* __restrict__ offsets,
                           const T* __restrict__ data,
                           const T* __restrict__ x,
                           T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * k) return;
  const int64_t i = k == 1 ? tid : tid / k;
  const int64_t c = k == 1 ? 0 : tid - i * k;
  T acc = T(0);
  for (int d = 0; d < n_diags; ++d) {
    const int64_t j = i + __ldg(&offsets[d]);
    if (j >= 0 && j < n) {
      acc += data[static_cast<int64_t>(d) * n + i] * x[j * k + c];
    }
  }
  y[tid] = acc;
}

template <typename T>
int dia_spmv(int64_t n, int n_diags, int k, const void* offsets,
             const void* data, const void* x, void* y, void* stream) {
  if (n > 0) {
    const int64_t threads = n * k;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    dia_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n, n_diags, k, static_cast<const int64_t*>(offsets),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dia_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dia_spmv_f64(int64_t n, int n_diags, int k, const void* offsets,
                 const void* data, const void* x, void* y, void* stream) {
  return dia_spmv<double>(n, n_diags, k, offsets, data, x, y, stream);
}

int dia_spmv_f32(int64_t n, int n_diags, int k, const void* offsets,
                 const void* data, const void* x, void* y, void* stream) {
  return dia_spmv<float>(n, n_diags, k, offsets, data, x, y, stream);
}

}  // extern "C"
